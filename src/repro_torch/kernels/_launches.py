"""Launch counters of the kernel wrappers.

Each wrapper carries ``launches`` (and, where its entry point picks a path,
``launches_by_path``; the flash op also ``launches_by_mask``) as attributes that ``chip_smoke.py`` resets and reads.
The search trains candidates on several host threads at once, and
``op.launches += 1`` is a read-modify-write that the interpreter lock does
not make atomic, so every wrapper counts through :func:`count_launch`.
A CUDA graph's replay calls no wrapper: its runner counts for it what the
wrappers counted while it was captured (:func:`launches_since`,
:func:`add_launches`).

A wrapper called on tensors without data (the dry run's fake tensors)
launches nothing and counts nothing: it reports the kernel's flops and
bytes through :func:`record_fake_call` instead.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

_LOCK = threading.Lock()
_COUNTED: Dict[int, Any] = {}     # every op counted so far, by id


def count_launch(op: Any, path: Optional[str] = None,
                 mask: Optional[str] = None) -> None:
    """One launch of ``op``'s kernel, on ``path`` where it has paths, with
    ``mask`` where it has masks."""
    with _LOCK:
        _COUNTED[id(op)] = op
        op.launches += 1
        if path is not None:
            op.launches_by_path[path] += 1
        if mask is not None:
            op.launches_by_mask[mask] += 1


# ---------------------------------------------------------------------------
# Launches of a captured CUDA graph
# ---------------------------------------------------------------------------

Counts = Dict[int, Tuple[Any, int, Dict[str, int], Dict[str, int]]]


def _counters(op) -> Tuple[int, Dict[str, int], Dict[str, int]]:
    return (op.launches, dict(getattr(op, "launches_by_path", {})),
            dict(getattr(op, "launches_by_mask", {})))


def _delta(now: Dict[str, int], then: Dict[str, int]) -> Dict[str, int]:
    return {k: c - then.get(k, 0) for k, c in now.items()
            if c != then.get(k, 0)}


def launch_counts() -> Counts:
    """Every counted op's counters now (for :func:`launches_since`)."""
    with _LOCK:
        return {k: (op,) + _counters(op) for k, op in _COUNTED.items()}


def launches_since(before: Counts) -> List[tuple]:
    """What each op counted since ``before``: [(op, launches, by path, by
    mask)] of the ops that counted any."""
    out = []
    with _LOCK:
        for k, op in _COUNTED.items():
            n, paths, masks = _counters(op)
            n0, paths0, masks0 = before.get(k, (op, 0, {}, {}))[1:]
            if n != n0:
                out.append((op, n - n0, _delta(paths, paths0),
                            _delta(masks, masks0)))
    return out


def add_launches(counted: List[tuple], times: int = 1) -> None:
    """Count ``times`` more of what :func:`launches_since` returned
    (negative to take it back): a graph captured by calling the wrappers,
    which count as they are called though nothing launches then, and
    replayed without calling them, where every kernel launches."""
    with _LOCK:
        for op, n, paths, masks in counted:
            op.launches += times * n
            for p, c in paths.items():
                op.launches_by_path[p] += times * c
            for m, c in masks.items():
                op.launches_by_mask[m] += times * c


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
