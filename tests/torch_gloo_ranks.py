"""Four gloo ranks on a (2, 2) ("data", "model") mesh run reduced models
on DTensors, each against the same model on one device; run by
``tests/test_torch_sharding.py::test_four_gloo_ranks_match_one_device``:

  PYTHONPATH=src python tests/torch_gloo_ranks.py OUT.json CKPT_DIR

Rank 0 writes, for each arch, the largest elementwise difference of the
train step's loss and grads, the prefill logits, one decode step's logits
and the cache it writes, and of a checkpoint saved from DTensors by the
mesh's training loop and taken up by the loop with no mesh.
"""
import dataclasses
import json
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("qwen3-4b", "dbrx-132b", "dbrx-132b-ep", "zamba2-7b")
# (arch, config changes): "dbrx-132b" on the sort path, whose semantics
# are global at any mesh; "dbrx-132b-ep" on the EP path (its two
# all-to-alls over "model") at a capacity where no pair drops, where it
# equals the one-device sort path
VARIANTS = {"dbrx-132b": ("dbrx-132b", dict(moe_impl="sort")),
            "dbrx-132b-ep": ("dbrx-132b", dict(capacity_factor=8.0))}
B, S, PROMPT = 4, 32, 24


def _diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _full(t):
    from repro_torch.distributed.sharding import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _arch(arch, mesh, rank):
    from repro_torch.configs import reduced_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.step import value_and_grad

    arch, change = VARIANTS.get(arch, (arch, {}))
    cfg = dataclasses.replace(reduced_config(arch), **change)
    bundle = build_model(cfg)
    params = bundle.init(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    batch = {"tokens": tokens, "labels": labels}
    rules = rules_for(arch, multi_pod=False, global_batch=B)
    out = {}
    ref_metrics, ref_grads = value_and_grad(params, batch, bundle)
    ref_logits, ref_cache = bundle.prefill(
        params, {"tokens": tokens[:, :PROMPT], "cache_len": S})
    ref_step, _ = bundle.decode_step(params, ref_cache,
                                     {"tokens": tokens[:, PROMPT:PROMPT + 1]})
    with sh.axis_rules(rules, mesh):
        dp = sh.distribute_params(params, bundle.specs(), rules, mesh)
        _, axes = bundle.input_specs(ShapeCell("t", "train", S, B))
        db = sh.distribute_params(batch, axes, rules, mesh)
        metrics, grads = value_and_grad(dp, db, bundle)
        out["loss"] = _diff(_full(metrics["loss"]), ref_metrics["loss"])
        # each grad on its param's placements: the data-parallel reduce
        out["grad_placements"] = all(
            tuple(g.placements) == tuple(p.placements)
            for g, p in zip(tree_leaves(grads), tree_leaves(dp)))
        out["grads"] = max(_diff(a, b) for a, b in zip(
            tree_leaves(sh.full_tree(grads)), tree_leaves(ref_grads)))
        prompt = sh.distribute_params({"t": tokens[:, :PROMPT]},
                                      {"t": ("batch", "seq")}, rules, mesh)
        logits, cache = bundle.prefill(dp, {"tokens": prompt["t"],
                                            "cache_len": S})
        out["prefill"] = _diff(_full(logits), ref_logits)
        # decode from the dry run's cache layout: head_dim over "model"
        cache = sh.distribute_params(sh.full_tree(cache),
                                     bundle.cache_specs(), rules, mesh)
        step = sh.distribute_params({"t": tokens[:, PROMPT:PROMPT + 1]},
                                    {"t": ("batch", None)}, rules, mesh)
        logits, cache = bundle.decode_step(dp, cache, {"tokens": step["t"]})
        out["decode"] = _diff(_full(logits), ref_step)
        out["cache"] = max(_diff(_full(cache[k]), ref_cache[k])
                           for k in cache if isinstance(ref_cache[k],
                                                        torch.Tensor))
    return out


def _checkpoint(mesh, rank, ckpt_dir):
    """qwen3-4b trained 2 steps on the mesh (a checkpoint every step,
    from DTensors), then the loop with no mesh restores step 2 and runs to
    3: its loss at step 2 against a run with no mesh from the start."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.lm import LMDataConfig, data_iterator
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.registry import build_model
    from repro_torch.training.loop import LoopConfig, train_loop

    cfg = reduced_config("qwen3-4b")
    bundle = build_model(cfg)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)

    def loop(steps, path, mesh_=None):
        return train_loop(bundle, lambda s: data_iterator(data, s),
                          LoopConfig(total_steps=steps, ckpt_every=1,
                                     ckpt_dir=path, log_every=1),
                          device="cpu", log=lambda _: None, mesh=mesh_)

    with axis_rules(rules_for("qwen3-4b", multi_pod=False, global_batch=B),
                    mesh):
        loop(2, ckpt_dir, mesh)
    dist.barrier()
    if rank != 0:
        return None
    resumed = loop(3, ckpt_dir)
    clean = loop(3, ckpt_dir + "_clean")
    return {"resumed_loss": abs(resumed["loss_at"][2] - clean["loss_at"][2]),
            "resumed_params": max(_diff(a, b) for a, b in zip(
                _leaves(resumed["state"].params),
                _leaves(clean["state"].params)))}


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def _rank(rank, world, store, out_path, ckpt_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    result = {arch: _arch(arch, mesh, rank) for arch in ARCHS}
    result["checkpoint"] = _checkpoint(mesh, rank, ckpt_dir)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out_path, ckpt_dir = sys.argv[1], sys.argv[2]
    os.makedirs(ckpt_dir, exist_ok=True)
    # the ranks meet through a file beside the output, not a TCP port that
    # another process could take between its choice and its use
    store = os.path.abspath(out_path) + ".rendezvous"
    try:
        mp.spawn(_rank, args=(4, store, out_path, ckpt_dir), nprocs=4)
    finally:
        if os.path.exists(store):
            os.remove(store)
