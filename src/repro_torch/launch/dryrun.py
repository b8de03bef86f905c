"""Dry run: one step of every (arch x shape x mesh) cell on a fake mesh.

Counterpart of ``repro/launch/dryrun.py``.  Run each invocation as its
own process (``python -m repro_torch.launch.dryrun``): it starts a
``"fake"`` process group of 256 ranks (``--mesh single``: (16, 16), axes
(data, model)) or 512 (``--mesh multi``: (2, 16, 16), axes (pod, data,
model)) in which this process is rank 0, and builds the production mesh
on it, a ``"cuda"`` DeviceMesh.  No card and no data: the params' shapes
come from ``init`` under ``FakeTensorMode``; the params, the optimizer
state, the batch and the cache are placed by their logical specs as
DTensors whose local shards are tensors of the meta device (each op a
shape computation); then the cell's step (``make_train_step``, a prefill
step or ``decode_step``) runs once under :class:`~repro_torch.launch.
roofline.LocalOpCounter`.  Collectives of the fake group return at
once; the counter records what rank 0 would compute, move and hold.  The
kernel wrappers take their branch for tensors without data (an empty
output, no launch) and report their work by the formula of their bound.
(Fake ``"cuda"`` tensors would do, but a PyTorch built without CUDA
cannot index them, and meta shards run several times faster.)

The reference costs a ``lax.scan`` over layers as its body times the trip
count.  Eager PyTorch runs every layer, and a step of a full-depth model
is a million local ops, so the port measures the step at the smallest
depths that tell each kind of layer apart (:func:`depth_knobs`: one and
two layers; a hybrid's groups and tail layers; an encoder-decoder's
encoder and decoder layers) and takes every count linearly to the
config's depth, as the layers are alike.  The params are placed at full
depth, and their bytes on rank 0 are checked against what the specs
imply.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape decode_32k --mesh single --out dryrun.jsonl

Each cell appends one ``CellReport`` line (``repro``'s keys) to ``--out``;
the exit code is 0 when every cell is ``ok``.  ``compile_s`` is the
seconds the measured steps took (the port compiles nothing).  The roofline
terms take the H100's constants (``roofline.H100_SXM``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed.sharding import (
    axis_rules,
    distribute_params,
    is_dtensor,
    spec_for,
    tree_map_specs,
)
from repro_torch.launch.mesh import (
    make_production_mesh,
    production_mesh_shape,
    rules_for,
)
from repro_torch.launch.roofline import (
    H100_SXM,
    CellReport,
    LocalOpCounter,
    _tensors,
    roofline_terms,
)
from repro_torch.models.registry import build_model
from repro_torch.training.step import (
    TrainState,
    make_optimizer,
    make_prefill_step,
    make_train_step,
)


DEVICE = "meta"     # where the local shards live (no data)


def fake_process_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks, this process rank 0
    (an existing group of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _on_device(tree: Any, device: str) -> Any:
    """Every tensor leaf of ``tree`` (meta or fake) as an empty tensor of
    its shape and dtype on ``device``."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    return tree


def _local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of ``tree``'s tensors."""
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for t in _tensors(tree))


def implied_local_bytes(shapes: Any, spec_tree: Any, rules,
                        mesh_sizes: Dict[str, int]) -> int:
    """Bytes of one rank's shards as the specs imply them, by arithmetic
    alone: each dim of each leaf split into ceil(size / ways) for the
    mesh axes its logical axis resolves to (rank 0's shard)."""
    total = [0]

    def one(_, leaf, axes):
        if not isinstance(leaf, torch.Tensor):
            return
        spec = spec_for(axes if axes is not None else (), rules, mesh_sizes)
        n = 1
        for dim, size in enumerate(leaf.shape):
            entry = spec[dim] if dim < len(spec) else None
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            ways = math.prod(mesh_sizes[a] for a in names)
            n *= -(-size // ways)
        total[0] += n * leaf.element_size()
    tree_map_specs(one, shapes, spec_tree)
    return total[0]


def _model_flops(cfg, cell) -> float:
    """MODEL_FLOPS (useful work), as the reference computes it."""
    n_embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_body = max(cfg.active_param_count() - n_embed, 1)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        if cfg.family == "encdec":
            tokens = cell.global_batch * (cell.seq_len
                                          + cell.seq_len // cfg.dec_ratio)
        return 6.0 * n_body * tokens
    if cell.kind == "prefill":
        return 2.0 * n_body * cell.global_batch * cell.seq_len
    return 2.0 * n_body * cell.global_batch


# ---------------------------------------------------------------------------
# Depth
# ---------------------------------------------------------------------------


def depth_knobs(cfg) -> Dict[str, int]:
    """The counts of each kind of layer: ``layers`` (an LM), ``groups``
    and ``tail`` (a hybrid: groups of ``attn_period`` Mamba layers and the
    shared block, then tail Mamba layers), ``enc`` and ``dec`` (an
    encoder-decoder)."""
    if cfg.family in ("ssm", "hybrid"):
        period = cfg.attn_period or cfg.n_layers + 1
        groups = cfg.n_layers // period
        return {"groups": groups, "tail": cfg.n_layers - groups * period}
    if cfg.family == "encdec":
        return {"enc": cfg.n_layers, "dec": cfg.n_dec_layers}
    return {"layers": cfg.n_layers}


def with_depth(cfg, knobs: Dict[str, int]):
    """``cfg`` at the depth ``knobs`` give (:func:`depth_knobs`)."""
    if "groups" in knobs:
        period = cfg.attn_period or 0
        return dataclasses.replace(
            cfg, n_layers=knobs["groups"] * period + knobs["tail"])
    if "enc" in knobs:
        return dataclasses.replace(cfg, n_layers=knobs["enc"],
                                   n_dec_layers=knobs["dec"])
    return dataclasses.replace(cfg, n_layers=knobs["layers"])


def depth_plan(cfg) -> Tuple[Dict[str, int], Dict[str, Dict[str, int]]]:
    """(the smallest depth: one of each kind the config has, and for each
    kind the config has more than one of, that depth with one more).
    A count is linear in the knobs, so these measurements give it at any
    depth."""
    full = depth_knobs(cfg)
    base = {k: min(v, 1) for k, v in full.items()}
    return base, {k: dict(base, **{k: 2}) for k, v in full.items() if v > 1}


def extrapolate(base: Dict[str, float], steps: Dict[str, Dict[str, float]],
                full: Dict[str, int], at: Dict[str, int]) -> Dict[str, float]:
    """Counts at depth ``full`` from the counts at depth ``at`` (``base``)
    and at one more layer of each kind (``steps``)."""
    out = dict(base)
    for kind, counts in steps.items():
        for key in out:
            out[key] += (full[kind] - at[kind]) * (counts[key] - base[key])
    return out


# ---------------------------------------------------------------------------
# One measured step
# ---------------------------------------------------------------------------


_SCALARS = ("arg_bytes", "out_bytes", "peak_bytes", "flops", "bytes_hbm",
            "bytes_hbm_min", "bytes_collective", "n_ops")


def _measure(cfg, cell, rules, mesh) -> Tuple[Dict[str, float],
                                               LocalOpCounter]:
    """One step of ``cfg`` on ``cell`` under the counter: its counts
    (:data:`_SCALARS`, then ``coll:<kind>`` and ``kernel:<name>:<what>``)
    and the counter."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    bundle = build_model(cfg)
    with FakeTensorMode():
        shapes = bundle.init(0, "cpu")
    counter = LocalOpCounter()
    with axis_rules(rules, mesh):
        params = distribute_params(_on_device(shapes, DEVICE),
                                   bundle.specs(), rules, mesh)
        batch_specs, batch_axes = bundle.input_specs(cell)
        batch = distribute_params(_on_device(batch_specs, DEVICE),
                                  batch_axes, rules, mesh)
        if cell.kind == "train":
            opt = make_optimizer(cfg)
            step, _ = make_train_step(bundle, optimizer=opt)
            args = (TrainState(0, params, opt.init(params)), batch)
        elif cell.kind == "prefill":
            step = make_prefill_step(bundle, cache_len=cell.seq_len)
            args = (params, batch)
        else:
            step = bundle.decode_step
            args = (params, distribute_params(
                _on_device(bundle.cache_shapes(cell), DEVICE),
                bundle.cache_specs(), rules, mesh), batch)
        arg_bytes = _local_bytes(args)
        counter.hold(args)
        with counter:
            out = step(*args)
        out_bytes = _local_bytes(out)
    c = counter.c
    counts = dict(arg_bytes=arg_bytes, out_bytes=out_bytes,
                  peak_bytes=c.peak_bytes, flops=c.flops,
                  bytes_hbm=c.bytes_hbm, bytes_hbm_min=c.bytes_hbm_min,
                  bytes_collective=c.bytes_collective, n_ops=c.n_ops)
    counts.update({f"coll:{k}": v for k, v in c.coll_breakdown.items()})
    for name, k in c.kernels.items():
        counts.update({f"kernel:{name}:{what}": v for what, v in k.items()})
    return counts, counter


def _with_keys(counts: Dict[str, float], keys) -> Dict[str, float]:
    return {k: counts.get(k, 0.0) for k in keys}


def run_cell(arch: str, shape: str, multi_pod: bool,
             rule_overrides: Optional[Dict[str, Any]] = None,
             verbose: bool = True,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             details: Optional[Dict[str, Any]] = None) -> CellReport:
    """One cell on the fake production mesh: its step measured at the
    depths of :func:`depth_plan` and taken to the config's depth.
    ``details``, if given, receives what a ``CellReport`` has no key for:
    this rank's param bytes at full depth (``param_bytes``) beside the
    bytes the specs imply (``param_bytes_implied``), the kernels' calls,
    flops and bytes (``kernels``), the local ops (``n_ops``) and the
    depths measured (``depths``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cell = SHAPES[shape]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    bundle = build_model(cfg)
    report = CellReport(arch=arch, shape=shape, mesh=mesh_name,
                        kind=cell.kind, ok=False)

    supported, why = bundle.supports(cell)
    if not supported:
        report.note = f"SKIPPED: {why}"
        report.ok = True
        return report

    sizes = production_mesh_shape(multi_pod)
    chips = math.prod(sizes.values())
    fake_process_group(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    rules = rules_for(arch, multi_pod=multi_pod,
                      global_batch=cell.global_batch,
                      overrides=rule_overrides)

    # ---- the params at full depth: rank 0's bytes against the specs -------
    with FakeTensorMode():
        shapes = bundle.init(0, "cpu")
    with axis_rules(rules, mesh):
        full = _on_device(shapes, DEVICE)
        param_bytes = _local_bytes(distribute_params(
            full, bundle.specs(), rules, mesh))
    implied = implied_local_bytes(full, bundle.specs(), rules, sizes)
    del shapes, full

    # ---- the step at the smallest depths, taken to full depth -------------
    t0 = time.monotonic()
    at, plan = depth_plan(cfg)
    base, counter = _measure(with_depth(cfg, at), cell, rules, mesh)
    steps = {}
    for kind, knobs in plan.items():
        steps[kind], counter = _measure(with_depth(cfg, knobs), cell, rules,
                                        mesh)
    keys = sorted(set(base).union(*steps.values()))
    total = extrapolate(_with_keys(base, keys),
                        {k: _with_keys(v, keys) for k, v in steps.items()},
                        depth_knobs(cfg), at)
    report.compile_s = time.monotonic() - t0
    c = counter.c

    # ---- memory (per device) ---------------------------------------------
    report.arg_bytes = total["arg_bytes"]
    report.out_bytes = total["out_bytes"]
    report.peak_bytes = total["peak_bytes"]
    report.temp_bytes = total["peak_bytes"] - total["arg_bytes"]

    # ---- roofline ----------------------------------------------------------
    terms = roofline_terms(total["flops"] * chips, total["bytes_hbm"] * chips,
                           total["bytes_collective"] * chips, chips,
                           H100_SXM)
    report.flops_dev = total["flops"]
    report.bytes_dev = total["bytes_hbm"]
    report.bytes_dev_min = total["bytes_hbm_min"]
    report.coll_dev = total["bytes_collective"]
    report.coll_breakdown = {k[5:]: v for k, v in total.items()
                             if k.startswith("coll:") and v}
    report.compute_s = terms.compute_s
    report.memory_s = terms.memory_s
    report.collective_s = terms.collective_s
    report.dominant = terms.dominant
    # the largest buffers and products of the deepest step measured
    report.top_buffers = [f"{b/2**20:.0f}MiB {desc}"
                          for b, desc in counter.sorted(c.top_buffers)]
    report.note = " | ".join(
        [f"TOPDOT {f/1e12:.2f}TF {d[:80]}"
         for f, d in counter.sorted(c.top_dots)[:4]]
        + [f"TOPCOLL {b/2**20:.0f}MiB {d[:80]}"
           for b, d in counter.sorted(c.top_colls)[:4]])

    # ---- MODEL_FLOPS (useful work) -----------------------------------------
    report.model_flops = _model_flops(cfg, cell)
    report.useful_fraction = report.model_flops / max(
        total["flops"] * chips, 1.0)
    report.ok = True
    if details is not None:
        kernels: Dict[str, Dict[str, float]] = {}
        for k, v in total.items():
            if k.startswith("kernel:"):
                _, name, what = k.split(":")
                kernels.setdefault(name, {})[what] = v
        details.update(param_bytes=param_bytes,
                       param_bytes_implied=implied, kernels=kernels,
                       n_ops=total["n_ops"], chips=chips,
                       depths=[at] + list(plan.values()))

    if verbose:
        coll = ", ".join(f"{k} {v/2**30:.3f}GiB"
                         for k, v in report.coll_breakdown.items()) or "none"
        print(f"[dryrun] {arch} x {shape} x {mesh_name}: ok "
              f"steps={report.compile_s:.1f}s "
              f"peak/dev={report.peak_bytes/2**30:.2f}GiB "
              f"params/dev={param_bytes/2**30:.3f}GiB "
              f"flops/dev={report.flops_dev:.4g} "
              f"bytes/dev={report.bytes_dev:.4g} coll/dev: {coll} "
              f"dominant={report.dominant} "
              f"useful={report.useful_fraction:.3f}", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=ALL_ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=None, help="append JSONL report here")
    ap.add_argument("--rules", default=None,
                    help="JSON dict of logical->physical rule overrides")
    ap.add_argument("--config", default=None,
                    help="JSON dict of ModelConfig field overrides "
                         "(e.g. '{\"microbatches\": 4}')")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ALL_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    overrides = json.loads(args.rules) if args.rules else None
    cfg_overrides = json.loads(args.config) if args.config else None

    ok = True
    for arch in archs:
        for shape in shapes:
            try:
                rep = run_cell(arch, shape, args.mesh == "multi", overrides,
                               cfg_overrides=cfg_overrides)
            except Exception:  # noqa: BLE001
                rep = CellReport(arch=arch, shape=shape,
                                 mesh="2x16x16" if args.mesh == "multi"
                                 else "16x16",
                                 kind=SHAPES[shape].kind, ok=False,
                                 error=traceback.format_exc()[-2000:])
                print(f"[dryrun] {arch} x {shape} FAILED:\n{rep.error}",
                      flush=True)
                ok = False
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rep.to_dict()) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
