"""What every config pass shares: the presets as ``(name, config)``
pairs and one finding at a virtual ``<contract:kind:name>`` path."""

from __future__ import annotations

from stmgcn_tpu_torch.analysis.report import Finding
from stmgcn_tpu_torch.analysis.rules import RULES


def preset_configs() -> list:
    """``(name, ExperimentConfig)`` of every preset the port ships."""
    from stmgcn_tpu_torch.config import PRESETS

    return [(name, build()) for name, build in PRESETS.items()]


def finding(rule: str, kind: str, name: str, message: str) -> Finding:
    return Finding(rule=rule, path=f"<contract:{kind}:{name}>", line=0, message=message,
                   severity=RULES[rule].severity)


def resident_budget() -> int:
    """The trainer's floor of "auto" residency, the budget the memory
    passes hold a config to (imported here, so importing the passes pulls
    in no model stack)."""
    from stmgcn_tpu_torch.train.trainer import Trainer

    return Trainer.RESIDENT_CAP_BYTES
