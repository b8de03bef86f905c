"""Logical-axis sharding: the bridge from model code to the device mesh.

Counterpart of ``repro/distributed/sharding.py``.  Model code annotates
parameters and activations with *logical* axis names ("embed", "heads",
"batch", ...).  The launcher installs a rule set mapping logical names to
mesh axes ("pod", "data", "model") for the current run; everything
composes through an ambient, thread-local context, so model code never
mentions mesh axes.  With no rules installed (one device, the CPU tests)
every annotation is a no-op.

The reference's ``NamedSharding`` becomes a list of DTensor placements,
one per mesh dim (:func:`placements_for`), over a ``torch.distributed``
``DeviceMesh`` whose dim names are the mesh axes.  XLA's SPMD partitioner
inserts the reference's collectives; DTensor's sharding propagation
inserts the port's.

Default mapping (DESIGN.md §5):

* ``batch``  -> ("pod", "data")   — data parallelism
* ``embed``  -> "data"            — FSDP weight sharding (all-gather per layer)
* ``heads`` / ``kv_heads`` / ``mlp`` / ``vocab`` -> "model" — tensor parallelism
* ``experts`` -> "model"          — expert parallelism
* ``layers`` / ``seq`` -> None    — unsharded by default (seq-parallel is a
  per-cell override used by the perf pass)
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import torch

Physical = Union[None, str, Tuple[str, ...]]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name or a tuple of
    them (major to minor).  Equal, entry for entry, to the reference's
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries: Physical) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def default_rules(multi_pod: bool = False) -> Dict[str, Physical]:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch_axes,
        "seq": None,
        "embed": "data",          # FSDP axis of every weight matrix
        "embed_unsharded": None,
        "heads": "model",         # TP over the flattened h*hd projection dim
        # kv projections replicate across TP ranks (kv_heads < 16 for every
        # assigned arch); KV *caches* shard their head_dim axis instead.
        "kv_heads": None,
        "head_dim": "model",
        "mlp": "model",
        "expert_mlp": None,
        "experts": "model",       # expert parallelism
        "vocab": "model",
        "layers": None,
        "layer_groups": None,
    }


@contextlib.contextmanager
def axis_rules(rules: Optional[Dict[str, Physical]], mesh):
    """Install (rules, mesh) for the enclosed region; ``mesh`` is a
    ``DeviceMesh`` with named dims (or a ``{name: size}`` dict where only
    specs are resolved).  Over a DeviceMesh a plain tensor meeting a
    DTensor in an op counts as replicated (DTensor's
    ``implicit_replication``): positions, masks and lengths the model
    makes on the fly are the same on every rank."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (rules, mesh)
    try:
        if mesh is None or isinstance(mesh, dict) or _implicit():
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _state.ctx = prev


def _implicit() -> bool:
    """Whether DTensor's implicit replication is on (in this thread): a
    nested ``axis_rules`` leaves it to the outer one, whose exit turns it
    off."""
    from torch.distributed.tensor import DTensor
    return DTensor._op_dispatcher._allow_implicit_replication


def current_rules() -> Optional[Dict[str, Physical]]:
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[1] if ctx else None


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's dim names; a ``{name: size}`` dict stands for a mesh
    where only names and sizes matter (no devices)."""
    if isinstance(mesh, dict):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names or ())


def _resolve(axis: Optional[str], rules: Dict[str, Physical],
             mesh, taken: set) -> Physical:
    """Map one logical axis; drop mesh axes already used or absent."""
    if axis is None:
        return None
    phys = rules.get(axis)
    if phys is None:
        return None
    if isinstance(phys, str):
        phys = (phys,)
    names = mesh_axis_names(mesh)
    usable = tuple(a for a in phys if a in names and a not in taken)
    taken.update(usable)
    if not usable:
        return None
    return usable if len(usable) > 1 else usable[0]


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Dict[str, Physical]] = None,
             mesh=None) -> PartitionSpec:
    rules = rules if rules is not None else current_rules()
    mesh = mesh if mesh is not None else current_mesh()
    if rules is None or mesh is None:
        return P()
    taken: set = set()
    return P(*[_resolve(a, rules, mesh, taken) for a in logical_axes])


def placements_for(spec: Sequence[Physical], mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one entry per mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names that mesh dim, else
    ``Replicate()``.  A dim sharded over several mesh axes (("pod",
    "data")) is split major to minor, DTensor's default order."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out: list = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry,) if isinstance(entry, str) else entry:
            out[names.index(name)] = Shard(dim)
    return out


def logical_constraint(x, *logical_axes: Optional[str]):
    """Redistribute a DTensor to the placements the rules give its logical
    axes (the reference's ``with_sharding_constraint``); trailing axes not
    named are unsharded.  A no-op without rules and a mesh, or for a plain
    tensor."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    axes = list(logical_axes) + [None] * (x.ndim - len(logical_axes))
    want = placements_for(spec_for(axes, rules, mesh), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# Trees: dicts and lists are containers; a spec leaf is a tuple (or None)
# ---------------------------------------------------------------------------


def tree_map_specs(fn: Callable[[Any, Any], Any], template: Any,
                   spec_tree: Any, path: str = "") -> Any:
    """``fn(path, leaf, axes)`` over ``template``'s leaves beside the
    logical-axis tuples of ``spec_tree`` (a tree of the same structure)."""
    if isinstance(template, dict):
        return {k: tree_map_specs(fn, template[k], spec_tree[k],
                                  f"{path}.{k}" if path else str(k))
                for k in template}
    if isinstance(template, list):
        return [tree_map_specs(fn, t, s, f"{path}.{i}" if path else str(i))
                for i, (t, s) in enumerate(zip(template, spec_tree,
                                               strict=True))]
    return fn(path, template, spec_tree)


def spec_leaves(spec_tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, axes) of every leaf of a spec tree."""
    if isinstance(spec_tree, dict):
        return [x for k, v in spec_tree.items()
                for x in spec_leaves(v, f"{path}.{k}" if path else str(k))]
    if isinstance(spec_tree, list):
        return [x for i, v in enumerate(spec_tree)
                for x in spec_leaves(v, f"{path}.{i}" if path else str(i))]
    return [(path, spec_tree)]


def shardings_like(template: Any, spec_tree: Any, rules=None, mesh=None
                   ) -> Any:
    """Placement lists for ``template``'s structure from a parallel tree
    of logical-axis tuples."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules if rules is not None else current_rules()
    return tree_map_specs(
        lambda _, __, axes: placements_for(
            spec_for(axes if axes is not None else (), rules, mesh), mesh),
        template, spec_tree)


def tree_shardings(spec_tree: Any, rules=None, mesh=None) -> Any:
    """Map a tree of logical-axis tuples to placement lists."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules if rules is not None else current_rules()
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, rules, mesh)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [tree_shardings(v, rules, mesh) for v in spec_tree]
    return placements_for(spec_for(spec_tree or (), rules, mesh), mesh)


def validate_divisibility(template: Any, spec_tree: Any, rules,
                          mesh_shape: Dict[str, int]) -> list:
    """Static launch-time check: every sharded dim must divide evenly.

    Returns a list of human-readable violations (empty == valid).  Works
    on anything with a ``shape`` (tensors on the meta device, fake
    tensors, ``torch.Size``) beside logical specs, with no devices, so
    configs are validated before anything is allocated."""
    problems: list = []

    def check(name, leaf, axes):
        if axes is None:
            return
        shape = tuple(getattr(leaf, "shape", leaf) or ())
        taken: set = set()
        for dim, logical in enumerate(axes):
            if logical is None or dim >= len(shape):
                continue
            phys = rules.get(logical)
            if phys is None:
                continue
            if isinstance(phys, str):
                phys = (phys,)
            usable = [a for a in phys if a in mesh_shape and a not in taken]
            taken.update(usable)
            total = math.prod(mesh_shape[a] for a in usable)
            if total > 1 and shape[dim] % total:
                problems.append(
                    f"{name}: dim {dim} ({logical}) size {shape[dim]} "
                    f"not divisible by {total} ({usable})")

    tree_map_specs(check, template, spec_tree)
    return problems


# ---------------------------------------------------------------------------
# DTensors
# ---------------------------------------------------------------------------


def local_chunk(t: torch.Tensor, mesh, placements: Sequence) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``placements``
    (``torch.chunk``'s split, DTensor's), cut locally with no collective:
    every rank holds the same ``t``."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    local = t
    for mdim, pl in enumerate(placements):
        if not isinstance(pl, Shard):
            continue
        n, c = mesh.size(mdim), coord[mdim]
        size = local.shape[pl.dim]
        full = -(-size // n)
        start = min(full * c, size)
        local = local.narrow(pl.dim, start, min(size, start + full) - start)
    return local


def from_full(t: torch.Tensor, mesh, placements: Sequence):
    """A DTensor of global value ``t`` (the same on every rank) under
    ``placements``, each rank keeping only its own shard."""
    from torch.distributed.tensor import DTensor

    local = local_chunk(t, mesh, placements)
    if local.shape != t.shape:      # a shard: keep it, not the full tensor
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local.detach().requires_grad_(t.requires_grad),
                              mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(params: Any, spec_tree: Any, rules, mesh) -> Any:
    """``params`` (a tree of full tensors, the same on every rank) as
    DTensors on ``mesh``, each leaf placed as ``spec_tree``'s logical axes
    resolve under ``rules``.  Leaves that are not tensors pass through."""
    def one(_, leaf, axes):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return from_full(leaf, mesh, placements_for(
            spec_for(axes if axes is not None else (), rules, mesh), mesh))
    return tree_map_specs(one, params, spec_tree)


def full_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as its full tensor (a collective:
    call it on every rank), other leaves as they are."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [full_tree(v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[full_tree(v) for v in tree])
    return tree.full_tensor() if is_dtensor(tree) else tree


def fit_placements(placements: Sequence, shape: Sequence[int], mesh) -> list:
    """``placements`` with every ``Shard`` that would split a dim unevenly
    replaced by ``Replicate`` (a kernel's local shard must be whole)."""
    from torch.distributed.tensor import Replicate, Shard

    out, ways = [], {}
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = ways.get(pl.dim, 1) * mesh.size(mdim)
            if shape[pl.dim] % n:
                pl = Replicate()
            else:
                ways[pl.dim] = n
        out.append(pl)
    return out


def logical_placements(shape: Sequence[int], axes: Sequence[Optional[str]],
                       mesh) -> list:
    """The placements the installed rules give ``axes`` on ``mesh``, each
    uneven split dropped (:func:`fit_placements`)."""
    rules = current_rules()
    if rules is None:
        rules = default_rules("pod" in mesh_axis_names(mesh))
    return fit_placements(placements_for(spec_for(axes, rules, mesh), mesh),
                          shape, mesh)


def local_call(fn: Callable, args: Sequence[Any],
               in_placements: Sequence[Optional[Sequence]],
               out_placements: Sequence[Optional[Sequence]]):
    """``fn`` on this rank's local shards, its outputs DTensors again.

    Each DTensor argument is redistributed to its entry of
    ``in_placements`` (``None``: passed as it is) and handed to ``fn`` as
    its local tensor; each output of ``fn`` (a tuple) becomes a DTensor
    with its entry of ``out_placements`` (``None``: returned as it is).
    A plain tensor argument with placements is taken as the same on every
    rank and cut to its shard.  A ``Partial`` out placement says the ranks
    of that mesh dim each hold a summand.  With no DTensor among ``args``
    this is ``fn(*args)``.

    The local gradient of an input is a summand (``Partial``) on every mesh
    dim where the input is replicated and another input is sharded: there
    the ranks split the work, each seeing part of the input's uses.  On
    the other dims it keeps the input's placements."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    split = [any(pl is not None and isinstance(pl[m], Shard)
                 for a, pl in zip(args, in_placements)
                 if isinstance(a, torch.Tensor))
             for m in range(mesh.ndim)]
    local = []
    for a, pl in zip(args, in_placements):
        if pl is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not is_dtensor(a):       # the same on every rank: cut its shard
            local.append(local_chunk(a, mesh, pl))
            continue
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        grad_pl = [Partial() if split[m] and not isinstance(p, Shard) else p
                   for m, p in enumerate(pl)]
        local.append(a.to_local(grad_placements=grad_pl))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(
        o if pl is None else DTensor.from_local(o, mesh, pl, run_check=False)
        for o, pl in zip(outs, out_placements, strict=True))
    return wrapped[0] if single else wrapped


def mesh_rank(mesh, placements: Sequence, dim: int) -> Tuple[int, int]:
    """(this rank's index among the shards of tensor dim ``dim``, their
    number) under ``placements``."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx = idx * mesh.size(mdim) + coord[mdim]
            n *= mesh.size(mdim)
    return idx, n


def replicated_like(t: torch.Tensor, ref, axes: Sequence[Optional[str]]):
    """``t``, a plain tensor that is the same on every rank (positions, a
    table of them), as a DTensor on ``ref``'s mesh placed as the rules say
    for ``axes``; ``t`` itself where ``ref`` is no DTensor.  An op that
    meets a DTensor and a plain tensor needs DTensor's implicit
    replication, which a backward pass on another thread does not see."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    mesh = ref.device_mesh
    return from_full(t, mesh, logical_placements(t.shape, axes, mesh))
