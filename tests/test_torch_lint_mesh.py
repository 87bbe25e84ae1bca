"""The port's mesh passes (``stmgcn_tpu_torch/analysis/collective_check.py``
and ``spmd_check.py``) against the JAX package's.

- ``collective-shape`` gives the JAX pass's findings (rule, severity, path,
  line, chain, count, and the message up to its hint) on every preset and
  on the JAX tests' cases (``tests/test_analysis.py`` ``TestCollectiveChecks``
  and ``TestBranchBandwidthFloor``), each config edited the same way in
  both packages; the three bandwidth helpers agree over a grid of inputs;
- ``estimate_shard_footprint`` equals the JAX estimate on every preset,
  on ``scaled`` at region 4 and with the halo plan forced, and
  ``spmd-shard-footprint`` fires at ``budget = total - 1`` and not at
  ``total`` in both packages (``tests/test_spmd_check.py``
  ``TestShardFootprint``);
- the executed half (rule, severity, path, line, chain and count; the
  messages name counted calls where the JAX ones name HLO ops): the wire
  models' fire/pass boundaries on stats dicts, each against the JAX pass
  on the same collectives as compiled HLO lines (``TestWireRuleBoundaries``: 128 bytes against an ``f_cap``
  of 8 and of 7, the dp slack's edge), the per-call bound read off the
  largest call, and ``manifest_findings`` as the JAX manifest rule;
- the declared manifests' coverage on the presets, and its two findings;
- ``banded_meta`` as the JAX one, and the collective layer's per-call
  maxima (``CommStats.max_bytes``, ``step_comm_report``'s window).
"""

import pytest

from stmgcn_tpu.analysis import collective_check as jax_cc
from stmgcn_tpu.analysis import spmd_check as jax_spmd
from stmgcn_tpu.config import PRESETS as JAX_PRESETS
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.parallel.manifest import CollectiveDecl as JaxDecl
from stmgcn_tpu.parallel.manifest import CollectiveManifest as JaxManifest
from stmgcn_tpu_torch.analysis import collective_check as cc
from stmgcn_tpu_torch.analysis import spmd_check as spmd
from stmgcn_tpu_torch.config import PRESETS, preset
from stmgcn_tpu_torch.parallel.manifest import CollectiveDecl, CollectiveManifest
from stmgcn_tpu_torch.utils import comm


def _edited(make, name, edits):
    cfg = make(name)
    for section, fields in edits.items():
        for field, value in fields.items():
            setattr(getattr(cfg, section), field, value)
    return cfg


def _keys(findings):
    """What must agree across the packages: rule, severity, path, line,
    chain, and (the list's length) count."""
    return sorted((f.rule, f.severity, f.path, f.line, tuple(f.chain)) for f in findings)


def _records(findings):
    """:func:`_keys` and the message up to its hint (the config passes'
    messages are the JAX ones there)."""
    return sorted((f.rule, f.severity, f.path, f.line, tuple(f.chain),
                   f.message.split(" — ")[0]) for f in findings)


# -- collective-shape ---------------------------------------------------------------

#: (preset, {section: {field: value}}, findings): the JAX tests' cases
COLLECTIVE_CASES = {
    "ragged-dp-batch": ("multicity", {"train": {"batch_size": 30}}, 1),
    "branch-psum-raggedness": ("default", {"mesh": {"branch": 2}}, 1),
    "halo-exceeding-shard": ("scaled", {"mesh": {"halo": 999}}, 1),
    "banded-over-budget": ("scaled", {"mesh": {"region_strategy": "banded", "halo": 100}}, 2),
    "oversharded-grid": ("scaled", {"mesh": {"region": 64}}, 1),
    "single-device-skipped": ("smoke", {"train": {"batch_size": 31}}, 0),
    "similarity-floor-pass": ("scaled", {"mesh": {"region_strategy": "banded", "halo": 125},
                                         "model": {"kernel_type": "localpool"}}, 0),
    "similarity-floor-fire": ("scaled", {"mesh": {"region_strategy": "banded", "halo": 124},
                                         "model": {"kernel_type": "localpool"}}, 1),
    "auto-stays-silent": ("scaled", {"mesh": {"halo": 10}}, 0),
    "sparse-exchanges-no-halo": ("scaled", {"mesh": {"halo": 999}, "model": {"sparse": True}},
                                 0),
    "bandedbranch-halo": ("bandedbranch", {"mesh": {"halo": 9999}}, 1),
    "bandedbranch-forced": ("bandedbranch", {"mesh": {"region_strategy": "banded", "halo": 4}},
                            2),
}


@pytest.mark.parametrize("case", sorted(COLLECTIVE_CASES))
def test_collective_shape_matches_jax(case):
    name, edits, count = COLLECTIVE_CASES[case]
    want = jax_cc.check_collective_contracts([(case, _edited(jax_preset, name, edits))])
    got = cc.check_collective_contracts([(case, _edited(preset, name, edits))])
    assert _records(got) == _records(want)
    assert len(got) == count and all(f.rule == "collective-shape" for f in got)
    assert all(f.path == f"<contract:collective:{case}>" for f in got)


def test_collective_shape_clean_on_every_preset_as_jax():
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    for name in PRESETS:
        assert cc.check_collective_contracts([(name, preset(name))]) == []
        assert jax_cc.check_collective_contracts([(name, jax_preset(name))]) == []
    assert cc.check_collective_contracts() == []


def test_collective_messages_name_the_numbers():
    f = cc.check_collective_contracts(
        [("b", _edited(preset, "scaled", COLLECTIVE_CASES["similarity-floor-fire"][1]))])
    assert "similarity branch's bandwidth floor 125" in f[0].message
    f = cc.check_collective_contracts([("b", _edited(preset, "scaled", {"mesh": {"region": 64}}))])
    assert "exceeds the shard size 40" in f[0].message


def test_bandwidth_helpers_match_jax_over_a_grid():
    for kernel in ("chebyshev", "random_walk_diffusion", "localpool"):
        for k in (1, 2, 3, 5):
            for cols in (1, 2, 7, 50, 128):
                assert cc.grid_bandwidth_estimate(kernel, k, cols) == \
                    jax_cc.grid_bandwidth_estimate(kernel, k, cols)
    for n in (1, 2, 9, 10, 11, 100, 2500, 4096):
        for kind in ("transport", "similarity"):
            assert cc.expected_branch_nnz(kind, n) == jax_cc.expected_branch_nnz(kind, n)
        for nnz in (0, 1, n, 2 * n + 1, 3 * n, n * n // 10 + 1, n * n):
            assert cc.branch_bandwidth_floor(n, nnz) == jax_cc.branch_bandwidth_floor(n, nnz)
    assert cc.expected_branch_nnz("similarity", 2500) == 625_000
    assert cc.branch_bandwidth_floor(2500, 625_000) == 125
    for mod in (cc, jax_cc):
        with pytest.raises(ValueError):
            mod.expected_branch_nnz("grid", 10)


# -- spmd-shard-footprint ---------------------------------------------------------

FOOTPRINT_CASES = {name: (name, {}) for name in PRESETS}
FOOTPRINT_CASES.update({
    "scaled-region4": ("scaled", {"mesh": {"region": 4}}),
    "scaled-banded": ("scaled", {"mesh": {"region_strategy": "banded"}}),
    "scaled-banded-halo": ("scaled", {"mesh": {"region_strategy": "banded", "halo": 40}}),
    "multicity-horizon": ("multicity", {"data": {"horizon": 3}}),
})


@pytest.mark.parametrize("case", sorted(FOOTPRINT_CASES))
def test_shard_footprint_equals_jax(case):
    name, edits = FOOTPRINT_CASES[case]
    got = spmd.estimate_shard_footprint(_edited(preset, name, edits))
    assert got == jax_spmd.estimate_shard_footprint(_edited(jax_preset, name, edits))
    assert got["total_bytes"] == got["supports_bytes"] + got["batch_bytes"] > 0


def test_banded_strips_beat_dense_shards():
    dense = spmd.estimate_shard_footprint(preset("scaled"))
    banded = spmd.estimate_shard_footprint(_edited(preset, "scaled",
                                                   FOOTPRINT_CASES["scaled-banded"][1]))
    region4 = spmd.estimate_shard_footprint(_edited(preset, "scaled",
                                                    FOOTPRINT_CASES["scaled-region4"][1]))
    assert banded["supports_bytes"] < 0.5 * dense["supports_bytes"]
    assert region4["supports_bytes"] > 1.5 * dense["supports_bytes"]


@pytest.mark.parametrize("name", ["branchpar", "scaled", "multicity", "bandedbranch"])
def test_shard_footprint_fire_pass_boundary_as_jax(name):
    total = spmd.estimate_shard_footprint(preset(name))["total_bytes"]
    for budget, fires in ((total, False), (total - 1, True)):
        got = spmd.check_shard_footprints([("b", preset(name))], budget_bytes=budget)
        want = jax_spmd.check_shard_footprints([("b", jax_preset(name))], budget_bytes=budget)
        assert _records(got) == _records(want)
        assert bool(got) == fires
    (f,) = spmd.check_shard_footprints([("b", preset(name))], budget_bytes=total - 1)
    assert (f.rule, f.path) == ("spmd-shard-footprint", "<contract:spmd:b>")
    assert "per-core budget" in f.message


def test_footprints_fit_the_trainers_budget_and_single_devices_are_out_of_scope():
    from stmgcn_tpu_torch.train.trainer import Trainer

    assert spmd.check_shard_footprints() == []
    assert jax_spmd.check_shard_footprints() == []
    assert spmd.check_spmd_contracts() == []
    for name in ("multicity", "scaled", "branchpar", "bandedbranch"):
        assert spmd.estimate_shard_footprint(preset(name))["total_bytes"] < \
            Trainer.RESIDENT_CAP_BYTES
    assert spmd.check_shard_footprints([("s", preset("smoke"))], budget_bytes=0) == []


# -- the executed half: wire models and manifests -------------------------------------

MESH_2x4 = ((2, 4), ("dp", "region"))
_PERMUTE = ("  %collective-permute.3 = f32[2,2,8]{2,1,0} collective-permute(%x), "
            "source_target_pairs={{0,1},{1,2},{2,3},{3,0},{4,5},{5,6},{6,7},{7,4}}")
_AG_DP = "  %all-gather.9 = f32[2,4]{1,0} all-gather(%p0), replica_groups=[4,2]<=[2,4]T(1,0)"


def _ar_dp(n: int, i: int = 5) -> str:
    return f"  %all-reduce.{i} = f32[{n}]{{0}} all-reduce(%g), replica_groups=[4,2]<=[2,4]T(1,0)"


DECLS = (("all-gather", "region"), ("collective-permute", "region"), ("all-reduce", "dp"))
JAX_M = JaxManifest("t", tuple(JaxDecl(k, a) for k, a in DECLS))
PORT_M = CollectiveManifest("t", tuple(CollectiveDecl(k, a) for k, a in DECLS))


def _stats(*calls):
    """A step's stats dict (``step_comm_report``'s shape) from ``(kind,
    axis, bytes)`` calls."""
    stats = comm.CommStats()
    for kind, axis, nbytes in calls:
        stats.add(kind, axis, nbytes)
    return stats.snapshot()


#: (HLO lines, the same calls, meta, findings)
WIRE_CASES = {
    "permute-at-cap": ([_PERMUTE], [("collective-permute", "region", 128)],
                       {"halo": 2, "b_local": 2, "m_local": 1, "f_cap": 8}, 0),
    "permute-over-cap": ([_PERMUTE], [("collective-permute", "region", 128)],
                         {"halo": 2, "b_local": 2, "m_local": 1, "f_cap": 7}, 1),
    "two-permutes-each-at-cap": ([_PERMUTE, _PERMUTE.replace(".3", ".4")],
                                 [("collective-permute", "region", 128)] * 2,
                                 {"halo": 2, "b_local": 2, "m_local": 1, "f_cap": 8}, 0),
    "dp-at-slack-edge": ([_ar_dp(1056)], [("all-reduce", "dp", 4224)], {"param_bytes": 64}, 0),
    "dp-over-slack-edge": ([_ar_dp(1057)], [("all-reduce", "dp", 4228)], {"param_bytes": 64}, 1),
    "dp-split-over-edge": ([_ar_dp(1000), _ar_dp(57, 6)],
                           [("all-reduce", "dp", 4000), ("all-reduce", "dp", 228)],
                           {"param_bytes": 64}, 1),
    "dense-program-no-permute-bound": ([_PERMUTE], [("collective-permute", "region", 128)],
                                       {"param_bytes": 64}, 0),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_models_match_jax(case):
    hlo, calls, meta, count = WIRE_CASES[case]
    want = jax_spmd.analyze_program("p", "\n".join(hlo), JAX_M, *MESH_2x4, meta=meta)
    got = spmd.wire_findings("p", _stats(*calls), meta)
    assert _keys(got) == _keys(want)
    assert len(got) == count and all(f.rule == "spmd-wire-budget" for f in got)
    assert spmd.manifest_findings("p", PORT_M, _stats(*calls)) == []


def test_wire_messages_and_figures():
    hlo, calls, meta, _ = WIRE_CASES["permute-over-cap"]
    (f,) = spmd.wire_findings("p", _stats(*calls), meta)
    assert "boundary-rows bound 112" in f.message and f.path == "<contract:spmd:p>"
    (f,) = spmd.wire_findings("p", _stats(*WIRE_CASES["dp-over-slack-edge"][1]),
                              {"param_bytes": 64})
    assert "gradient-sync model" in f.message and "4,228 bytes" in f.message
    assert spmd.wire_figures(_stats(*WIRE_CASES["two-permutes-each-at-cap"][1]),
                             {"halo": 2, "b_local": 2, "m_local": 1, "f_cap": 8,
                              "param_bytes": 64}) == {
        "permute_max": 128, "permute_cap": 128, "dp_bytes": None, "dp_cap": 4224}


@pytest.mark.parametrize("case", ["undeclared", "required-missing", "clean"])
def test_manifest_findings_match_jax(case):
    required = (("collective-permute", "region", True),)
    hlo, calls, decls = {
        "undeclared": ([_PERMUTE, _AG_DP], [("collective-permute", "region", 128),
                                            ("all-gather", "dp", 32)], required),
        "required-missing": ([_ar_dp(4)], [("all-reduce", "dp", 16)],
                             required + (("all-reduce", "dp", False),)),
        "clean": ([_PERMUTE], [("collective-permute", "region", 128)], required),
    }[case]
    want = jax_spmd.analyze_program(
        "p", "\n".join(hlo), JaxManifest("t", tuple(JaxDecl(k, a, r) for k, a, r in decls)),
        *MESH_2x4)
    got = spmd.manifest_findings(
        "p", CollectiveManifest("t", tuple(CollectiveDecl(k, a, r) for k, a, r in decls)),
        _stats(*calls))
    assert _keys(got) == _keys(want)
    assert len(got) == (case != "clean")
    assert all(f.rule == "spmd-collective-manifest" for f in got)


def test_declared_manifests_cover_every_mesh_preset():
    names = {n for n in PRESETS if preset(n).mesh.n_devices > 1}
    assert names == {"multicity", "scaled", "branchpar", "bandedbranch"}
    assert spmd.PROGRAM_SPECS == jax_spmd.PROGRAM_SPECS
    got = spmd.declared_manifests()
    want = jax_spmd.declared_manifests()
    assert set(got) == {f"{n}/{k}" for n in names for k in ("train", "serve")} == set(want)
    for name, manifest in got.items():
        assert manifest.to_dict() == want[name].to_dict(), name
    assert spmd.check_manifest_coverage() == []


def test_manifest_coverage_findings(monkeypatch):
    from stmgcn_tpu_torch.parallel import placement

    monkeypatch.delitem(spmd.PROGRAM_SPECS, "scaled/serve")
    (f,) = spmd.check_manifest_coverage([("scaled", preset("scaled"))])
    assert (f.rule, f.path) == ("spmd-collective-manifest", "<contract:spmd:scaled>")
    assert "no declared serve program" in f.message
    monkeypatch.setattr(placement, "BRANCH_FUSION", (CollectiveDecl(
        "all-reduce", "region", required=True, reason="mis-declared"),))
    got = spmd.check_manifest_coverage([("branchpar", preset("branchpar"))])
    assert [(f.rule, f.path) for f in got] == [
        ("spmd-collective-manifest", "<contract:spmd:branchpar/train>"),
        ("spmd-collective-manifest", "<contract:spmd:branchpar/serve>")]
    assert "axis of extent 1 (region)" in got[0].message
    # configs named after no preset are out of its scope
    assert spmd.check_manifest_coverage([("mine", preset("branchpar"))]) == []


# -- banded_meta and the per-call maxima --------------------------------------------

def test_banded_meta_equals_jax():
    import types

    import numpy as np
    import torch

    from stmgcn_tpu.parallel.compose import banded_meta as jax_banded_meta
    from stmgcn_tpu_torch.parallel import banded_decompose, banded_meta

    cfg, jcfg = preset("bandedbranch"), jax_preset("bandedbranch")
    band = np.eye(16, k=1) + np.eye(16, k=-1)
    strips = (banded_decompose(band[None], 2), banded_decompose((band @ band)[None], 2))
    dense = torch.zeros(2, 16, 16)
    for sups in ((strips[0], dense, strips[1]), strips[0], (dense,), dense):
        trainer = types.SimpleNamespace(supports=sups)
        assert banded_meta(trainer, cfg) == jax_banded_meta(trainer, jcfg)
    meta = banded_meta(types.SimpleNamespace(supports=strips), cfg)
    assert meta == {"halo": 2, "b_local": cfg.train.batch_size // 2, "m_local": 1,
                    "f_cap": cfg.data.seq_len + 2 * cfg.model.lstm_hidden_dim
                    + cfg.model.gcn_hidden_dim}


def test_stats_keep_the_largest_call_and_the_report_its_window():
    stats = comm.CommStats()
    stats.add("collective-permute", "region", 64)
    stats.add("collective-permute", "region", 256)
    stats.add("all-reduce", "dp", 8)
    snap = stats.snapshot()
    assert snap["max_bytes"] == {"collective-permute/region": 256, "all-reduce/dp": 8}
    assert snap["ops"]["collective-permute/region"] == {"calls": 2, "bytes": 320}
    with stats.window() as peak:
        with stats.window() as inner:  # equal tables while both are open
            stats.add("collective-permute", "region", 32)
        stats.add("collective-permute", "region", 40)
        assert peak == {}  # filled when the block ends
    assert inner == {"collective-permute/region": 32}
    assert peak == {"collective-permute/region": 40}
    assert stats.snapshot()["max_bytes"]["collective-permute/region"] == 256
    stats.reset()
    assert stats.snapshot()["max_bytes"] == {}

    def step():
        comm.STATS.add("collective-permute", "region", 48)
        comm.STATS.add("collective-permute", "region", 16)
        return "done"

    comm.STATS.add("collective-permute", "region", 4096)  # before the step: not its own
    report = comm.step_comm_report(step)
    assert report["result"] == "done"
    assert report["max_bytes"] == {"collective-permute/region": 48}
    assert report["ops"] == {"collective-permute/region": {"calls": 2, "bytes": 64}}
