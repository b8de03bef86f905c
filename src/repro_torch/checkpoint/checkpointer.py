"""Atomic, async checkpointing of a tree of tensors.

Counterpart of ``repro/checkpoint/checkpointer.py``, on the same layout, so
either package restores what the other wrote:

* ``<dir>/step_<N>/`` holds one ``.npy`` per leaf, named by its tree path
  (dict keys, list indices and NamedTuple field names joined by dots),
  and ``index.json`` (step; each leaf's name, file, shape and dtype);
* bf16 (and fp8) leaves are stored as their raw bits (uint16, uint8), the
  logical dtype recorded in the index; numpy has no such dtypes, and the
  port reaches the bits through ``tensor.view(torch.int16)``;
* writes go to ``step_<N>.tmp`` and are renamed only when complete, so a
  crash mid-save never corrupts the latest checkpoint; ``keep`` bounds
  disk usage;
* ``save_async`` copies the leaves to host memory synchronously (the
  training step writes the params in place afterwards) and writes on a
  daemon thread; ``wait()`` joins before the next save or exit.

A DTensor leaf (a sharded run) is saved as its full tensor, so the layout
is the same whether or not the run had a mesh, and each package reads
it; restoring into a DTensor leaf puts each rank's shard back on that
leaf's placements.  Gathering a DTensor is a collective, so every rank
calls ``save``; only rank 0 writes, synchronously, and every rank waits
for it before going on.

The port keeps a model's layers as a list where ``repro`` stacks them, so
a ``repro`` checkpoint's leaf names differ from the port's:
:meth:`Checkpointer.restore_tree` reads any checkpoint into nested dicts,
and ``repro_torch.weights.train_state_from_jax`` maps ``repro``'s
``TrainState`` onto the port's.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import from_full, is_dtensor

# numpy has no bf16 or fp8: store the raw bits, the logical dtype in the
# index
_BITCAST_SAVE = {"bfloat16": (torch.int16, np.uint16),
                 "float8_e4m3fn": (torch.uint8, np.uint8),
                 "float8_e5m2": (torch.uint8, np.uint8)}
_BITCAST_LOAD = {"bfloat16": (np.int16, torch.bfloat16),
                 "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
                 "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, subtree) pairs in ``jax.tree_util``'s order (dict keys
    sorted), or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_path(tree: Any, prefix: str = "") -> Iterator[
        Tuple[str, Any]]:
    """(dotted path, leaf) of every leaf; ``None`` is an empty subtree."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix or "root", tree
        return
    for key, sub in kids:
        yield from flatten_with_path(sub, f"{prefix}.{key}" if prefix
                                     else key)


def _rebuild(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken in order from
    ``leaves`` (the order of :func:`flatten_with_path`)."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _host_array(x: Any) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf (never a view of a tensor the caller may
    write in place), bf16 and fp8 as their bits, and its logical dtype."""
    if is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).split(".")[-1]
        if name in _BITCAST_SAVE:
            return t.view(_BITCAST_SAVE[name][0]).numpy().view(
                _BITCAST_SAVE[name][1]), name
        return t.numpy(), name
    arr = np.asarray(x, dtype=np.int32 if isinstance(x, int) else None)
    return arr.copy(), str(arr.dtype)


def _load(folder: str, entry: Dict[str, Any]) -> torch.Tensor:
    arr = np.load(os.path.join(folder, entry["file"]))
    logical = entry["dtype"]
    if logical in _BITCAST_LOAD:
        np_bits, dtype = _BITCAST_LOAD[logical]
        return torch.from_numpy(arr.view(np_bits)).view(dtype)
    return torch.from_numpy(arr)


def _sharded(state: Any) -> bool:
    return any(is_dtensor(x) for _, x in flatten_with_path(state))


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Any) -> str:
        self.wait()
        snap = self._snapshot(state)
        if not _sharded(state):
            return self._write(step, snap)
        path = self._write(step, snap) if _rank() == 0 else None
        torch.distributed.barrier()
        return path or os.path.join(self.dir, f"step_{step:010d}")

    def save_async(self, step: int, state: Any) -> None:
        if _sharded(state):      # a collective, and one writer
            self.save(step, state)
            return
        self.wait()
        snap = self._snapshot(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, snap), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, state: Any) -> List[Tuple[str, np.ndarray, str]]:
        return [(name, *_host_array(x))
                for name, x in flatten_with_path(state)]

    def _write(self, step: int, snap) -> str:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {"step": step, "leaves": []}
        for name, arr, logical_dtype in snap:
            fname = re.sub(r"[^A-Za-z0-9_.-]", "_", name) + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            index["leaves"].append({"name": name, "file": fname,
                                    "shape": list(arr.shape),
                                    "dtype": logical_dtype})
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "index.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _index(self, step: Optional[int]) -> Tuple[int, str, Dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        folder = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(folder, "index.json")) as f:
            index = json.load(f)
        return step, folder, {e["name"]: e for e in index["leaves"]}

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[int, Any]:
        """Restore into the structure of ``like``: each tensor leaf comes
        back in the like leaf's dtype on its device, each int leaf (a step
        count) as an int."""
        step, folder, by_name = self._index(step)
        out = []
        for name, ref in flatten_with_path(like):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name}")
            t = _load(folder, by_name[name])
            shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) \
                else ()
            if tuple(t.shape) != shape:
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(t.shape)} vs {shape}")
            if is_dtensor(ref):
                out.append(from_full(
                    t.to(device=ref.to_local().device, dtype=ref.dtype),
                    ref.device_mesh, ref.placements))
            elif isinstance(ref, torch.Tensor):
                out.append(t.to(device=ref.device, dtype=ref.dtype))
            else:
                out.append(type(ref)(t.item()))
        return step, _rebuild(like, iter(out))

    def restore_tree(self, step: Optional[int] = None
                     ) -> Tuple[int, Dict[str, Any]]:
        """Every leaf of a checkpoint, whoever wrote it, as CPU tensors in
        nested dicts keyed by the parts of its dotted name (a ``repro``
        ``TrainState`` comes back as ``{"step", "params", "opt_state"}``
        with the reference's stacked layout)."""
        step, folder, by_name = self._index(step)
        tree: Dict[str, Any] = {}
        for name, entry in by_name.items():
            *parents, last = name.split(".")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = _load(folder, entry)
        return step, tree
