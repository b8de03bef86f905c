"""Launch counters of the kernel wrappers.

Each wrapper carries ``launches`` (and, where its entry point picks a path,
``launches_by_path``; the flash op also ``launches_by_mask``) as attributes that ``chip_smoke.py`` resets and reads.
The search trains candidates on several host threads at once, and
``op.launches += 1`` is a read-modify-write that the interpreter lock does
not make atomic, so every wrapper counts through :func:`count_launch`.
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
