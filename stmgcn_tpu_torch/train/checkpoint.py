"""Single-file checkpoints that the JAX package and the port both read and
write, with atomic, verified writes.

Counterpart of ``stmgcn_tpu/train/checkpoint.py``, byte for byte in the
format:

- **v2** (``STMG2\\n``): three blobs — JSON meta, params, optimizer state —
  each preceded by a ``<QI`` header (length, CRC32). **v1** (``STMG1\\n``,
  ``<Q`` lengths, no CRC) stays readable.
- The params and optimizer blobs are the msgpack documents
  ``flax.serialization.to_bytes`` writes (string-keyed maps with ndarray
  leaves), read and written here by the port's own codec
  (:mod:`~stmgcn_tpu_torch.train.msgpack_codec`). The trees are numpy:
  ``models/params.py`` converts the params, and the trainer's
  :class:`~stmgcn_tpu_torch.train.step.Optimizer` its optax-shaped state.
- Writes go to ``<path>.tmp.<pid>`` and are ``os.replace``d, so a crash
  mid-write never corrupts the previous checkpoint; the CRCs catch what
  the rename cannot (truncation or bit rot of a file that did land).

Every read verifies structure: a short header or blob, a CRC mismatch,
trailing bytes, an unknown magic or a blob that does not decode raises
:class:`CorruptCheckpointError` naming the path and the blob.
:func:`load_latest_verified` turns that into the recovery chain for
``--resume auto``: latest -> rotated previous latest -> best-k snapshots
(newest first) -> best, quarantining each corrupt candidate as
``<name>.corrupt`` with a logged reason.
"""

from __future__ import annotations

import glob as _glob
import io
import json
import os
import re
import struct
import zlib
from typing import Any, Callable, Optional

from stmgcn_tpu_torch.train import msgpack_codec

__all__ = [
    "CorruptCheckpointError",
    "FORMAT_VERSION",
    "load_checkpoint",
    "load_checkpoint_bytes",
    "load_latest_verified",
    "save_checkpoint",
    "serialize_checkpoint",
    "verify_checkpoint",
    "write_checkpoint_bytes",
]

_MAGIC_V1 = b"STMG1\n"
_MAGIC_V2 = b"STMG2\n"
#: current on-disk format: v2 = per-blob CRC32 (v1 files stay readable)
FORMAT_VERSION = 2
_BLOB_NAMES = ("meta", "params", "opt_state")
#: v2 per-blob header: little-endian (length: u64, crc32: u32)
_HEADER_V2 = struct.Struct("<QI")
_LEN_V1 = struct.Struct("<Q")


class CorruptCheckpointError(ValueError):
    """A checkpoint file failed structural or CRC verification: a short
    read, a CRC mismatch, trailing bytes, an unknown magic, or a blob that
    does not decode. The message names the path and the failing blob."""


def serialize_checkpoint(params: Any, opt_state: Any, meta: dict) -> bytes:
    """One self-contained v2 byte string from numpy trees and a JSON-able
    meta dict. The bytes own their data, so a background writer may hold
    them while training updates the live state."""
    blobs = [
        json.dumps(meta).encode("utf-8"),
        msgpack_codec.packb(params),
        msgpack_codec.packb(opt_state),
    ]
    out = [_MAGIC_V2]
    for blob in blobs:
        out.append(_HEADER_V2.pack(len(blob), zlib.crc32(blob)))
        out.append(blob)
    return b"".join(out)


def write_checkpoint_bytes(path: str, data: bytes, fault_plan=None) -> None:
    """Atomically write a serialized checkpoint (temp file + ``os.replace``).

    ``fault_plan`` (a :class:`~stmgcn_tpu_torch.resilience.FaultPlan`)
    gets its ``torn-write`` shot before the temp file is written: a crash
    between the temp write and the rename leaves a partial
    ``*.tmp.<pid>`` and never touches ``path``. ``None`` or the empty plan
    is the production no-op."""
    tmp = f"{path}.tmp.{os.getpid()}"
    if fault_plan is not None:
        fault_plan.torn_write(path, data, tmp)
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_checkpoint(path: str, params: Any, opt_state: Any, meta: dict, *,
                    fault_plan=None) -> None:
    """Atomically write ``params``/``opt_state``/``meta`` to ``path``;
    ``fault_plan`` reaches the byte-mutating write faults (truncate,
    corrupt) and the torn write."""
    data = serialize_checkpoint(params, opt_state, meta)
    if fault_plan is not None:
        data = fault_plan.mutate_write(path, data)
    write_checkpoint_bytes(path, data, fault_plan)


def _read_exact(f, n: int, path: str, what: str) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise CorruptCheckpointError(
            f"{path}: short read in {what} — wanted {n} bytes, file had "
            f"{len(data)} (truncated checkpoint?)"
        )
    return data


def _read_blobs(path: str, *, skip_opt_state: bool = False, verify_crc: bool = True,
                data: Optional[bytes] = None):
    """``(version, [meta, params, opt_state | None])`` bytes, every extent
    checked against the file and (v2, ``verify_crc``) every CRC. With
    ``skip_opt_state`` the optimizer blob's extent is still checked, and its
    CRC too unless ``verify_crc`` is off (the cheap inference read). With
    ``data`` the file's bytes are read from it (``path`` names them)."""
    with open(path, "rb") if data is None else io.BytesIO(data) as f:
        size = os.fstat(f.fileno()).st_size if data is None else len(data)
        magic = f.read(len(_MAGIC_V2))
        if magic == _MAGIC_V2:
            version = 2
        elif magic == _MAGIC_V1:
            version = 1
        else:
            raise CorruptCheckpointError(f"{path} is not a stmgcn-tpu checkpoint (magic {magic!r})")
        header = _HEADER_V2 if version == 2 else _LEN_V1
        blobs = []
        for name in _BLOB_NAMES:
            raw = _read_exact(f, header.size, path, f"{name} header")
            if version == 2:
                length, crc = header.unpack(raw)
            else:
                (length,) = header.unpack(raw)
                crc = None
            if f.tell() + length > size:
                raise CorruptCheckpointError(
                    f"{path}: {name} blob declares {length} bytes but only "
                    f"{size - f.tell()} remain (truncated checkpoint?)"
                )
            if name == "opt_state" and skip_opt_state and not (version == 2 and verify_crc):
                blobs.append(None)
                f.seek(length, os.SEEK_CUR)
                continue
            blob = _read_exact(f, length, path, f"{name} blob")
            if crc is not None and verify_crc and zlib.crc32(blob) != crc:
                raise CorruptCheckpointError(
                    f"{path}: CRC32 mismatch in {name} blob — expected "
                    f"{crc:#010x}, got {zlib.crc32(blob):#010x} "
                    "(bit rot or partial overwrite)"
                )
            blobs.append(None if name == "opt_state" and skip_opt_state else blob)
        if version == 2 and f.tell() != size:
            raise CorruptCheckpointError(
                f"{path}: {size - f.tell()} trailing bytes after the "
                "opt_state blob (corrupt or mixed-up file)"
            )
    return version, blobs


def _decode(path: str, name: str, blob: bytes):
    try:
        if name == "meta":
            return json.loads(blob.decode("utf-8"))
        return msgpack_codec.unpackb(blob)
    except (ValueError, TypeError, UnicodeDecodeError) as e:
        raise CorruptCheckpointError(f"{path}: {name} blob does not decode: {e}") from e


def load_checkpoint(path: str, *, load_opt_state: bool = True) -> tuple[dict, Any, Any]:
    """``(meta, params, opt_state)``: the meta dict and the two trees as
    nested dicts of numpy arrays. ``load_opt_state=False`` skips decoding
    the optimizer blob (about twice the parameters' bytes) and returns
    ``None`` for it — the inference read; its extent is still verified,
    its CRC is not."""
    _, blobs = _read_blobs(path, skip_opt_state=not load_opt_state, verify_crc=load_opt_state)
    meta = _decode(path, "meta", blobs[0])
    params = _decode(path, "params", blobs[1])
    opt_state = None if blobs[2] is None else _decode(path, "opt_state", blobs[2])
    return meta, params, opt_state


def load_checkpoint_bytes(data: bytes, path: str = "<bytes>", *,
                          load_opt_state: bool = True) -> tuple[dict, Any, Any]:
    """:func:`load_checkpoint` of a file's bytes (``path`` names them in
    errors): what a mesh rank decodes after the lead broadcast the file."""
    _, blobs = _read_blobs(path, skip_opt_state=not load_opt_state,
                           verify_crc=load_opt_state, data=data)
    meta = _decode(path, "meta", blobs[0])
    params = _decode(path, "params", blobs[1])
    opt_state = None if blobs[2] is None else _decode(path, "opt_state", blobs[2])
    return meta, params, opt_state


def verify_checkpoint(path: str) -> dict:
    """Check magic, every blob's extent and (v2) CRC, without decoding the
    trees; returns the parsed meta. Raises :class:`CorruptCheckpointError`
    on any violation."""
    _, blobs = _read_blobs(path)
    return _decode(path, "meta", blobs[0])


def _resume_candidates(out_dir: str) -> list[str]:
    """Recovery order: latest -> rotated previous latest -> best-k (newest
    epoch first) -> best."""
    paths = [os.path.join(out_dir, name) for name in ("latest.ckpt", "latest.prev.ckpt")]
    paths = [p for p in paths if os.path.exists(p)]
    bests = []
    for p in _glob.glob(os.path.join(out_dir, "best_e*.ckpt")):
        m = re.fullmatch(r"best_e(\d+)\.ckpt", os.path.basename(p))
        if m:
            bests.append((int(m.group(1)), p))
    paths.extend(p for _, p in sorted(bests, reverse=True))
    best = os.path.join(out_dir, "best.ckpt")
    if os.path.exists(best):
        paths.append(best)
    return paths


def load_latest_verified(
    out_dir: str,
    *,
    load_opt_state: bool = True,
    quarantine: bool = True,
    log: Optional[Callable[[str], None]] = None,
) -> Optional[tuple[str, dict, Any, Any]]:
    """``(path, meta, params, opt_state)`` of the newest checkpoint in
    ``out_dir`` that verifies, walking latest.ckpt -> latest.prev.ckpt ->
    best_e*.ckpt (newest epoch first) -> best.ckpt; ``None`` when nothing
    loads. A corrupt candidate is renamed ``<name>.corrupt``
    (``quarantine=True``) with the reason sent to ``log``, and never
    loaded."""
    for path in _resume_candidates(out_dir):
        try:
            verify_checkpoint(path)
        except (ValueError, OSError) as e:  # CorruptCheckpointError is a ValueError
            if quarantine:
                quarantined = path + ".corrupt"
                try:
                    os.replace(path, quarantined)
                except OSError:
                    quarantined = "(rename failed; left in place)"
                if log:
                    log(f"checkpoint {path} failed verification ({e}) — quarantined as "
                        f"{quarantined}")
            elif log:
                log(f"checkpoint {path} failed verification ({e}) — skipped")
            continue
        meta, params, opt_state = load_checkpoint(path, load_opt_state=load_opt_state)
        return path, meta, params, opt_state
    return None
