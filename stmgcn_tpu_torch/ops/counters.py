"""The kernel wrappers' launch counts, and the captures that defer them.

Each kernel wrapper counts its launches in a plain integer attribute of
its own (``fused_lstm.launches``, ``spmm_stack.launches_shared``, ...)
through :func:`bump`. While a CUDA graph is being captured
(:mod:`stmgcn_tpu_torch.graphs`) the wrappers' Python runs but nothing is
launched: :func:`recording` routes into the capture's record every count
made where the capture's predicate holds (the thread's current stream is
capturing: the capturing thread, and autograd's device thread, which runs
a backward's wrappers on the capture stream), and each replay of the graph
adds that record once (:func:`add`). Counts from other threads meanwhile
(an eager forward, an evaluation) are real launches and count at once. A
graphed run and an eager run therefore report the same launches.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Callable, Iterator, Optional

__all__ = ["add", "bump", "recording"]

_LOCK = threading.Lock()
#: the open capture's record and its predicate, or None; captures are
#: serialized (one at a time per process), so one slot is enough
_RECORD: Optional[Counter] = None
_CAPTURING: Optional[Callable[[], bool]] = None


def bump(fn, attr: str = "launches", n: int = 1) -> None:
    """Count ``n`` launches of ``fn`` in ``fn.<attr>``, or in the open
    capture's record when its predicate holds for the calling thread."""
    with _LOCK:
        if _RECORD is not None and _CAPTURING():
            _RECORD[fn, attr] += n
        else:
            setattr(fn, attr, getattr(fn, attr) + n)


def add(record) -> None:
    """Add a capture's record (``{(fn, attr): n}``) to the counts: one
    replay's launches."""
    with _LOCK:
        for (fn, attr), n in record.items():
            setattr(fn, attr, getattr(fn, attr) + n)


@contextlib.contextmanager
def recording(capturing: Callable[[], bool]) -> Iterator[Counter]:
    """Route into a fresh record, while the block runs, every :func:`bump`
    for which ``capturing()`` holds; yields the record. Not reentrant."""
    global _RECORD, _CAPTURING
    with _LOCK:
        if _RECORD is not None:
            raise RuntimeError("a capture is already recording launches")
        record = Counter()
        _RECORD, _CAPTURING = record, capturing
    try:
        yield record
    finally:
        with _LOCK:
            _RECORD = _CAPTURING = None
