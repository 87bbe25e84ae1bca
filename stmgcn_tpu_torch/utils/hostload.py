"""Host-load provenance and the inter-process bench lock.

Counterpart of ``stmgcn_tpu/utils/hostload.py`` (a copy: that module needs
no JAX, but the port imports nothing of the JAX package). A concurrent
Python process on the host (a probe child, a test run, a second bench)
depresses a host-clock measurement, so:

- :func:`host_load_snapshot` captures machine-verifiable load provenance
  (loadavg, core count, competing Python PIDs with command briefs) that a
  bench record embeds before and after its measurement, so a contended
  reading is flagged in the record itself (:func:`is_contended`);
- :class:`BenchLock` is an advisory ``flock`` every measurement holds
  while it measures; ``flock`` releases with the holder's death, so a
  crashed holder never leaves a stale lock behind;
- :func:`probe_backend_child` probes the CUDA device in a killable child
  process with a timeout, and :func:`wait_for_probe_children` lets such
  children drain before a measurement starts.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Optional

__all__ = [
    "LOCK_PATH",
    "PROBE_MARKER",
    "PROBE_SRC",
    "BenchLock",
    "host_load_snapshot",
    "is_contended",
    "measurement_preamble",
    "persist_measurement",
    "probe_backend_child",
    "wait_for_probe_children",
]

#: one lock per host (in the temporary directory): the resource serialized
#: is the host's cores and the card, not the checkout
LOCK_PATH = os.path.join(tempfile.gettempdir(), "stmgcn_torch_bench.lock")

#: the one device-probe snippet: a product on the card, then the device
#: type it ran on (a host without a card answers "cpu")
PROBE_SRC = (
    "import torch; d = 'cuda' if torch.cuda.is_available() else 'cpu'; "
    "x = torch.ones((8, 8), device=d); (x @ x).sum().item(); "
    "print(d)"
)

#: how a probe child is recognized in a /proc cmdline brief (derived, so an
#: edit to PROBE_SRC cannot strand the drain on a stale pattern)
PROBE_MARKER = PROBE_SRC[:40]


def _competing_python(max_procs: int = 16) -> list[dict]:
    """Python processes on the host other than this one and its ancestors.

    Reads ``/proc`` directly (no psutil needed). Ancestors are excluded:
    the shell chain that launched the measurement is not competing load.
    Children are NOT excluded: a probe child this process forked still
    burns a core.
    """
    me = os.getpid()
    ancestors = set()
    pid = me
    for _ in range(32):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().split(")")[-1].split()[1])
        except (OSError, ValueError, IndexError):
            break
        ancestors.add(pid)
        if ppid <= 1:
            break
        pid = ppid
    out = []
    try:
        pids = [int(p) for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return out
    for pid in pids:
        if pid in ancestors:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if not argv or b"python" not in os.path.basename(argv[0]):
            continue
        brief = b" ".join(argv[:4]).decode(errors="replace").strip()
        out.append({"pid": pid, "cmd": brief[:120]})
        if len(out) >= max_procs:
            break
    return out


def host_load_snapshot() -> dict:
    """One machine-verifiable snapshot of the host's load regime."""
    try:
        load1, load5, _ = os.getloadavg()
    except OSError:  # pragma: no cover - /proc-less host
        load1 = load5 = None
    return {
        "loadavg_1m": round(load1, 2) if load1 is not None else None,
        "loadavg_5m": round(load5, 2) if load5 is not None else None,
        "nproc": os.cpu_count(),
        "competing_python": _competing_python(),
    }


def is_contended(host_load: dict) -> bool:
    """Whether a record's host-load provenance shows a contended regime.

    ``host_load`` is the ``{"before": snapshot, "after": snapshot, ...}``
    dict bench records embed; any competing Python process on either side
    of the measurement counts. The persist policy keys off this: a
    contended record is still printed, but it never overwrites last-good
    evidence.
    """
    return bool(
        (host_load.get("before") or {}).get("competing_python")
        or (host_load.get("after") or {}).get("competing_python")
    )


def probe_backend_child(timeout_s: int = 120) -> Optional[str]:
    """Probe the CUDA device in a killable child: ``"cuda"`` when a product
    on the card finished, ``"cpu"`` when the child has no card, ``None``
    when it never answered (a wedged driver can block device init inside
    native code, where signal handlers never run). Safe against a
    zero-returncode child with empty stdout."""
    import subprocess
    import sys

    try:
        out = subprocess.run(
            [sys.executable, "-c", PROBE_SRC],
            timeout=timeout_s,
            capture_output=True,
        )
    except subprocess.TimeoutExpired:
        return None
    if out.returncode != 0:
        return None
    lines = out.stdout.decode().strip().splitlines()
    return lines[-1] if lines else None


def wait_for_probe_children(max_wait_s: float = 150.0, poll_s: float = 5.0) -> bool:
    """Wait (bounded) for lingering device-probe children to die: one
    blocked in device init can outlive its parent's kill and depress a
    concurrent measurement. A probe child is recognized by
    :data:`PROBE_MARKER`. Returns True when no probe child remains."""
    deadline = time.monotonic() + max_wait_s
    while True:
        lingering = [
            p for p in _competing_python() if PROBE_MARKER in p["cmd"]
        ]
        if not lingering or time.monotonic() >= deadline:
            return not lingering
        time.sleep(poll_s)


def measurement_preamble(wait_env: str = "STMGCN_BENCH_LOCK_WAIT"):
    """Standard start of every measurement script: acquire the host-wide
    bench lock (honoring ``STMGCN_BENCH_LOCK_PATH``), let lingering probe
    children drain, and snapshot the load regime. Returns ``(lock,
    load_before)``."""
    lock_path = os.environ.get("STMGCN_BENCH_LOCK_PATH")
    lock = BenchLock(lock_path) if lock_path else BenchLock()
    lock.acquire(wait_s=float(os.environ.get(wait_env, 300)))
    wait_for_probe_children()
    return lock, host_load_snapshot()


def persist_measurement(out_path: str, record: dict, on_gpu: bool, label: str) -> bool:
    """The one evidence-file overwrite policy: a record measured on the GPU
    persists; a CPU record persists only when the existing file is absent,
    unreadable, or itself a CPU record — never over GPU evidence; and a
    *contended* record (:func:`is_contended` over its ``host_load``) never
    overwrites a clean GPU record, whatever device it ran on. Stamps
    ``record["contended"]`` and ``record["persisted"]`` so the printed
    record says which happened, and returns the latter."""
    import json
    import sys

    contended = is_contended(record.get("host_load") or {})
    record["contended"] = contended
    existing = None
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                existing = json.load(f)
        except (OSError, ValueError):
            existing = None
    persist, why = True, ""
    if existing is not None and existing.get("platform") == "gpu":
        if not on_gpu:
            persist, why = False, "a CPU run"
        elif contended and not existing.get("contended"):
            persist, why = False, "a host-contended run"
    record["persisted"] = persist
    if persist:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
    else:
        print(
            f"{label}: NOT overwriting GPU record {out_path} with {why}",
            file=sys.stderr,
        )
    return persist


class BenchLock:
    """Advisory host-wide measurement lock (``flock`` on :data:`LOCK_PATH`).

    ``acquire(wait_s)`` polls non-blocking so the caller can bound its
    wait and *proceed anyway* on timeout — a measurement record with
    ``lock.acquired: false`` is still better than no record, and the
    ``host_load`` snapshot will show who was competing. The holder's PID
    is written into the file purely as a diagnostic; correctness rests on
    the flock, which the kernel releases when the holder exits.
    """

    def __init__(self, path: str = LOCK_PATH):
        self.path = path
        self._fd: Optional[int] = None
        self.acquired = False
        self.waited_s = 0.0

    def acquire(self, wait_s: float = 300.0, poll_s: float = 2.0) -> bool:
        import fcntl

        if self._fd is not None:  # re-acquire after timeout: reuse, don't leak
            os.close(self._fd)
            self._fd = None
        t0 = time.monotonic()
        try:
            self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o666)
        except OSError:
            # advisory contract: an unopenable lock file (e.g. another
            # user's 0644 /tmp file) must degrade to acquired=false, not
            # abort the measurement the lock exists to protect
            self.acquired = False
            self.waited_s = 0.0
            return False
        deadline = time.monotonic() + wait_s
        while True:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                self.acquired = True
                os.ftruncate(self._fd, 0)
                os.write(self._fd, str(os.getpid()).encode())
                break
            except OSError:
                if time.monotonic() >= deadline:
                    break
                time.sleep(poll_s)
        self.waited_s = round(time.monotonic() - t0, 1)
        return self.acquired

    def holder_pid(self) -> Optional[int]:
        """Best-effort PID of the current holder (diagnostic only)."""
        try:
            with open(self.path) as f:
                return int(f.read().strip() or 0) or None
        except (OSError, ValueError):
            return None

    def release(self) -> None:
        if self._fd is not None:
            import fcntl

            try:
                if self.acquired:
                    fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None
                self.acquired = False

    def __enter__(self) -> "BenchLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def record(self) -> dict:
        """The in-record provenance of this acquisition attempt."""
        rec = {"acquired": self.acquired, "waited_s": self.waited_s}
        if not self.acquired:
            rec["holder_pid"] = self.holder_pid()
        return rec
