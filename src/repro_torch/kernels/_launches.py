"""Launch counters of the kernel wrappers.

Each wrapper carries ``launches`` (and, where its entry point picks a path,
``launches_by_path``; the flash op also ``launches_by_mask``) as attributes that ``chip_smoke.py`` resets and reads.
The search trains candidates on several host threads at once, and
``op.launches += 1`` is a read-modify-write that the interpreter lock does
not make atomic, so every wrapper counts through :func:`count_launch`.

A wrapper called on tensors without data (the dry run's fake tensors)
launches nothing and counts nothing: it reports the kernel's flops and
bytes through :func:`record_fake_call` instead.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

_LOCK = threading.Lock()


def count_launch(op: Any, path: Optional[str] = None,
                 mask: Optional[str] = None) -> None:
    """One launch of ``op``'s kernel, on ``path`` where it has paths, with
    ``mask`` where it has masks."""
    with _LOCK:
        op.launches += 1
        if path is not None:
            op.launches_by_path[path] += 1
        if mask is not None:
            op.launches_by_mask[mask] += 1


# ---------------------------------------------------------------------------
# Calls without data: the dry run's fake tensors
# ---------------------------------------------------------------------------

_RECORDER: list = []


def is_fake(*ts: Any) -> bool:
    """Whether any of ``ts`` has no data: a tensor of ``FakeTensorMode``
    (the dry run's) or of the meta device.  A wrapper given one returns an
    empty output of the kernel's shape and dtype after its argument
    checks, launches nothing and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) or getattr(t, "is_meta", False)
               for t in ts)


def record_fake_call(name: str, flops: float, nbytes: float) -> None:
    """A wrapper's call on fake tensors: the kernel's work by the formula
    of its bound (``flops`` and the ``nbytes`` it must move), handed to
    the recorder installed by :func:`recording_fake_calls`, if any."""
    if _RECORDER:
        _RECORDER[-1](name, flops, nbytes)


class recording_fake_calls:
    """Within the block, ``fn(name, flops, nbytes)`` receives every fake
    call of a kernel wrapper."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        _RECORDER.append(self.fn)
        return self

    def __exit__(self, *exc):
        _RECORDER.remove(self.fn)
