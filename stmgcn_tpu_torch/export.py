"""Ahead-of-time export: a trained forecaster as one serving artifact.

Counterpart of ``stmgcn_tpu/export.py``. :class:`~stmgcn_tpu_torch.inference.
Forecaster` serves from a checkpoint but rebuilds the model from its config
at load time; :func:`export_forecaster` goes one step further down the
deployment path: it traces the forward of the forecaster's dense serving
clone with :func:`torch.export.export`, **parameters carried inside the
program**, the batch a symbolic ``torch.export.Dim``, and writes one file
holding the program (``torch.export.save`` bytes) beside the normalizer
statistics and the shape contract. :meth:`ExportedForecaster.load` rebuilds
a raw-units predictor from that file alone: no model classes, no config
machinery — ``torch.export``'s runtime, the numpy-only normalizer and
:func:`~stmgcn_tpu_torch.serving.predict.serve_predict`. Importing this
module loads neither ``stmgcn_tpu_torch.models`` nor ``.train`` nor
``.experiment`` (``tests/test_torch_export.py`` pins it).

**The LSTM is the hand-written kernel.** The program's recurrence is one
node per group of layers, the operator ``torch.ops.stmgcn.fused_lstm_fwd``
(``ops/fused_lstm.py``), whose implementation is picked where the program
runs: on the card it launches B1 (and counts the launch in
``fused_lstm.launches``), on the CPU it runs the plain version. The
operator is registered by ``stmgcn_tpu_torch.ops.fused_lstm``, which this
module imports: unlike the JAX artifact, which needs only JAX at load,
loading this one needs ``stmgcn_tpu_torch`` importable. The program is
traced on the CPU and moved to the target device at load
(``torch.export.passes.move_to_device_pass``), so one file serves both.
As the JAX export runs the LSTM through an ``lstm_backend="xla"`` clone, a
bf16 model's artifact runs the xla form of B1 (``launches_xla``) whatever
form its checkpoint names; at float32 the forms are one function.

Scope: artifacts take dense ``(M, K, N, N)`` support stacks (the serving
representation). Block-sparse- and tiled-trained forecasters export
transparently: their parameters are the same in every support mode
(``models/st_mgcn.py``), so the dense clone loads them unchanged.

File format (the JAX package's framing, ``_write_blobs``/``_read_blobs``):
a magic line, then length-prefixed blobs — the meta JSON and the
``torch.export.save`` bytes. The meta's ``format`` names the payload; a
JAX artifact (serialized StableHLO, no ``format``) is refused by name.
"""

from __future__ import annotations

import copy
import io
import json
import os
import struct
import warnings

import numpy as np
import torch

import stmgcn_tpu_torch.ops.fused_lstm  # noqa: F401 — registers the B1 operator
from stmgcn_tpu_torch.data.normalize import normalizer_from_dict
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.serving.predict import serve_predict

__all__ = ["FORMAT", "ExportedForecaster", "export_forecaster"]

_MAGIC = b"STMGX1\n"
#: the payload this package writes (meta ``format``)
FORMAT = "torch.export"
#: the largest batch one artifact takes (the symbolic batch's bound)
MAX_BATCH = 1 << 16


def _write_blobs(path: str, blobs: list) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        for blob in blobs:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_blobs(path: str, n: int) -> list:
    file_size = os.stat(path).st_size
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path} is not an stmgcn-tpu export artifact")
        blobs = []
        for _ in range(n):
            header = f.read(8)
            if len(header) != 8:
                raise ValueError(f"truncated export artifact: {path}")
            (size,) = struct.unpack("<Q", header)
            # bound the length field by the bytes present before reading:
            # a corrupt field fails cleanly instead of a huge allocation
            if size > file_size - f.tell():
                raise ValueError(f"truncated export artifact: {path}")
            blob = f.read(size)
            if len(blob) != size:
                raise ValueError(f"truncated export artifact: {path}")
            blobs.append(blob)
        if f.tell() != file_size:
            raise ValueError(f"trailing garbage after final blob in export artifact: {path}")
    return blobs


class _ServingForward(torch.nn.Module):
    """The exported signature: ``(supports (M, K, N, N), history (B, T, N,
    C)) -> predictions`` in the model's compute dtype."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, supports, history):
        return self.model(supports, history)


def _serving_clone(fc):
    """The forecaster's dense serving clone on the CPU: the dense model of
    its config, its bf16 LSTM in the xla form (as the JAX export's clone),
    its compute dtype, its parameters (frozen), the kernel route on every
    device."""
    from stmgcn_tpu_torch.experiment import build_model
    from stmgcn_tpu_torch.ops.layers import set_compute_dtype
    from stmgcn_tpu_torch.ops.lstm import StackedLSTM

    cfg = copy.deepcopy(fc.config)
    cfg.model.sparse, cfg.model.tiled, cfg.model.lstm_backend = False, False, "xla"
    model = build_model(cfg, fc.derived["input_dim"], device="cpu")
    model.load_state_dict({k: v.detach().cpu() for k, v in fc.model.state_dict().items()})
    set_compute_dtype(model, fc.model.compute_dtype)
    for mod in model.modules():
        if isinstance(mod, StackedLSTM):
            mod.kernel_route = True
    model.requires_grad_(False)
    return model.eval()


def export_forecaster(fc, path: str, *, city=None) -> None:
    """Write ``fc`` (a :class:`~stmgcn_tpu_torch.inference.Forecaster`) to
    ``path`` as a self-contained serving artifact (module docstring).

    A heterogeneous multi-city forecaster bakes ONE city's shape contract
    and normalizer per artifact (the program's region count is fixed):
    pass ``city`` to pick which, and export each city to its own file to
    serve them all.
    """
    hetero = getattr(fc, "normalizers", None) is not None
    if hetero and city is None:
        raise ValueError(
            "heterogeneous multi-city checkpoint: the artifact bakes one city's "
            "region count and normalizer — pass city= (export each city to its "
            "own artifact to serve them all)"
        )
    if not hetero and city is not None:
        raise ValueError("city= only applies to heterogeneous multi-city checkpoints")
    n_nodes = fc.derived["n_nodes"]
    normalizer = fc.normalizer
    if hetero:
        if not 0 <= city < len(fc.normalizers):
            raise ValueError(f"city must be in [0, {len(fc.normalizers)}), got {city}")
        n_nodes, normalizer = n_nodes[city], fc.normalizers[city]
    model = _serving_clone(fc)
    m, k, input_dim = model.m_graphs, model.n_supports, fc.derived["input_dim"]
    supports = torch.zeros(m, k, n_nodes, n_nodes)
    history = torch.zeros(2, fc.seq_len, n_nodes, input_dim)
    batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
    with torch.no_grad():
        program = torch.export.export(_ServingForward(model), (supports, history),
                                      dynamic_shapes=({}, {0: batch}))
    payload = io.BytesIO()
    torch.export.save(program, payload)
    meta = {
        "version": 1,
        "format": FORMAT,
        "torch": torch.__version__,
        "n_nodes": n_nodes,
        "input_dim": input_dim,
        "seq_len": fc.seq_len,
        "horizon": fc.horizon,
        "m_graphs": m,
        "n_supports": k,
        "dtype": str(model.compute_dtype or torch.float32).removeprefix("torch."),
        "normalizer": normalizer.to_dict() if normalizer is not None else None,
    }
    if hetero:
        meta["city"] = city
    _write_blobs(path, [json.dumps(meta).encode("utf-8"), payload.getvalue()])


class ExportedForecaster:
    """A serving artifact loaded back into a callable predictor.

    Same raw-units contract as ``Forecaster.predict`` — normalize the input,
    run the exported program, denormalize the output — rebuilt from the
    file alone. The support stack is placed on the device once and kept
    while the same stack keeps coming; a :class:`~stmgcn_tpu_torch.serving.
    engine.ServingEngine` built ``from_artifact`` re-routes :meth:`predict`
    through its bucket ladder.
    """

    def __init__(self, program, meta: dict, device):
        self._program = program
        self.meta = meta
        self.device = torch.device(device)
        #: the program as a callable module, ``(supports, history) -> predictions``
        self.module = program.module()
        self.normalizer = (
            normalizer_from_dict(meta["normalizer"]) if meta["normalizer"] else None
        )
        self._sup_src = None   # last supports object (identity check)
        self._sup_np = None    # its float32 numpy view (value check)
        self._sup_dev = None   # the copy on the device
        self._engine = None    # set by ServingEngine.from_artifact

    @classmethod
    def load(cls, path: str, device=None) -> "ExportedForecaster":
        """Read ``path`` onto ``device`` (``None`` means the GPU, and raises
        without one; ``device="cpu"`` runs the plain versions)."""
        device = resolve_device(device)
        meta_blob, program_blob = _read_blobs(path, 2)
        meta = json.loads(meta_blob.decode("utf-8"))
        if meta.get("version") != 1:
            raise ValueError(f"unsupported export version {meta.get('version')!r}")
        if meta.get("format") != FORMAT:
            if "platforms" in meta and "format" not in meta:
                raise ValueError(
                    f"{path} is a JAX artifact (serialized StableHLO for "
                    f"{meta['platforms']}): load it with stmgcn_tpu.export, or export "
                    "the checkpoint with stmgcn_tpu_torch.export_forecaster")
            raise ValueError(f"{path}: unsupported artifact format {meta.get('format')!r}")
        from torch.export.passes import move_to_device_pass

        with warnings.catch_warnings():
            # the archive's tensors are read from the blob's read-only bytes
            # (never written to: the parameters are constants of the program)
            warnings.filterwarnings("ignore", message="The given buffer is not writable")
            program = torch.export.load(io.BytesIO(program_blob))
        if device.type != "cpu":
            program = move_to_device_pass(program, device)
        return cls(program, meta, device)

    @property
    def seq_len(self) -> int:
        return self.meta["seq_len"]

    @property
    def horizon(self) -> int:
        return self.meta["horizon"]

    @property
    def exported(self):
        """The loaded :class:`torch.export.ExportedProgram` (symbolic batch)
        on this forecaster's device."""
        return self._program

    @property
    def support_shape(self) -> tuple:
        """``(M, K, N, N)``: the dense support stack the program takes."""
        n = self.meta["n_nodes"]
        return (self.meta["m_graphs"], self.meta["n_supports"], n, n)

    def check_supports(self, supports) -> np.ndarray:
        """``supports`` as float32 numpy, raising unless it is the
        program's ``(M, K, N, N)`` stack."""
        supports_np = np.asarray(supports, dtype=np.float32)
        if supports_np.shape != self.support_shape:
            raise ValueError(f"supports must be {self.support_shape}, got {supports_np.shape}")
        return supports_np

    def _pin_supports(self, supports, supports_np: np.ndarray) -> None:
        if self._sup_dev is not None and (
            supports is self._sup_src or np.array_equal(supports_np, self._sup_np)
        ):
            return
        self._sup_src, self._sup_np = supports, supports_np
        self._sup_dev = torch.as_tensor(supports_np, device=self.device)

    def _call(self, history: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = self.module(self._sup_dev, torch.as_tensor(history, device=self.device))
        return out.float().cpu().numpy()  # a bf16 program's predictions, exactly

    def predict(self, supports, history, *, normalized: bool = False) -> np.ndarray:
        """Forecast from raw-scale ``history`` ``(B, seq_len, N, C)`` (or
        model-scaled with ``normalized=True``) over the dense ``supports``
        stack; returns raw-unit forecasts ``(B, N, C)`` or ``(B, H, N, C)``
        as float32 numpy."""
        supports_np = self.check_supports(supports)
        engine = self._engine
        if engine is not None:
            # a ServingEngine wraps this artifact: requests route through its
            # bucket ladder and its pinned support stack
            if not (supports is engine.supports_np
                    or np.array_equal(supports_np, engine.supports_np)):
                raise ValueError(
                    "this artifact is wrapped by a ServingEngine pinned to a different "
                    "support stack — build a new engine to serve a different graph")
            return engine.predict(history, normalized=normalized)
        self._pin_supports(supports, supports_np)
        expected = (self.meta["seq_len"], self.meta["n_nodes"], self.meta["input_dim"])
        return serve_predict(self._call, self.normalizer, expected, history, normalized)
