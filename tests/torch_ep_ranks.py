"""Four gloo ranks run the port's ``moe_block`` on the cases of
tests/torch_ep_cases.py, each on its (data, model) mesh with its params
as DTensors; run by tests/test_torch_moe_ep.py:

  PYTHONPATH=src python tests/torch_ep_ranks.py OUT.npz

Rank 0 writes, per case, what tests/torch_ep_reference.py writes for
``repro`` (``y``, ``aux``, ``grad/<param>`` of ``sum(y ** 2) + aux``) and:
``ep`` (1 where the EP path ran); ``stages``, one row per
``_dispatch_local`` call of the forward on any rank: (rank, buckets,
capacity, rows, valid rows, kept rows); for the capacity-8 cases ``sort/*``,
the one-device sort path on the same inputs (values and grads); for the
empty-slot case ``no_empty/y`` and ``no_empty/stages``, the forward once
more with empty slots sorted past every expert (where the reference does
not put them).
"""
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ep_cases import AXES, CASES, case_inputs  # noqa: E402

WORLD = 4


def _loss_grads(block, p, x, cfg):
    """(y, aux, {param: grad}) of ``sum(y ** 2) + aux``, full tensors."""
    from repro_torch.distributed.sharding import full_tree
    y, aux = block(p, x, cfg)
    (y.pow(2).sum() + aux).backward()
    return full_tree(y), full_tree(aux), full_tree(
        {k: v.grad for k, v in p.items()})


def _case(name, rank, out):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    shape, _, _, _, grads = CASES[name]
    cfg_d, p_np, x_np = case_inputs(name)
    cfg = ModelConfig(**cfg_d)
    mesh = make_mesh(shape, AXES, "cpu")
    rules = sh.default_rules(multi_pod=False)
    ran_ep = []
    dispatch, ep = moe._dispatch_local, moe._moe_block_ep

    def recording(stages, empties_last=False):
        def call(ids, n_buckets, capacity, valid=None):
            if empties_last and valid is not None:
                res = dispatch(torch.where(valid, ids, n_buckets),
                               n_buckets + 1, capacity, valid)
            else:
                res = dispatch(ids, n_buckets, capacity, valid)
            stages.append((rank, n_buckets, capacity, ids.numel(),
                           ids.numel() if valid is None
                           else int(valid.sum()), int(res[3].sum())))
            return res
        return call

    def counted_ep(*a):
        ran_ep.append(1)
        return ep(*a)

    def gathered(stages):
        every = [None] * WORLD
        dist.all_gather_object(every, stages)
        return torch.tensor([s for rows in every for s in rows]
                            or [[0] * 6])

    def forward(patch, with_grads):
        moe._dispatch_local, moe._moe_block_ep = patch, counted_ep
        try:
            with sh.axis_rules(rules, mesh):
                p = sh.distribute_params(
                    {k: torch.from_numpy(v) for k, v in p_np.items()},
                    moe.moe_specs(cfg), rules, mesh)
                x = sh.distribute_params({"x": torch.from_numpy(x_np)},
                                         {"x": ("batch", None, None)},
                                         rules, mesh)["x"]
                if with_grads:
                    for v in p.values():
                        v.requires_grad_(True)
                    return _loss_grads(moe.moe_block, p, x, cfg)
                with torch.no_grad():
                    y, aux = moe.moe_block(p, x, cfg)
                return sh.full_tree(y), sh.full_tree(aux), {}
        finally:
            moe._dispatch_local, moe._moe_block_ep = dispatch, ep

    stages = []
    y, aux, g = forward(recording(stages), grads)
    out[f"{name}/stages"] = gathered(stages)
    out[f"{name}/y"], out[f"{name}/aux"] = y, aux
    out.update({f"{name}/grad/{k}": v for k, v in g.items()})
    out[f"{name}/ep"] = torch.tensor(int(bool(ran_ep)))
    if cfg.capacity_factor == 8.0:
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in p_np.items()}
        y, aux, g = _loss_grads(
            moe.moe_block, p, torch.from_numpy(x_np),
            dataclasses.replace(cfg, moe_impl="sort"))
        out[f"{name}/sort/y"], out[f"{name}/sort/aux"] = y, aux
        out.update({f"{name}/sort/grad/{k}": v for k, v in g.items()})
    if name.endswith("_empty"):
        stages = []
        out[f"{name}/no_empty/y"] = forward(recording(stages, True),
                                            False)[0]
        out[f"{name}/no_empty/stages"] = gathered(stages)


def _rank(rank, store, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    out: dict = {}
    for name in CASES:
        _case(name, rank, out)
    if rank == 0:
        np.savez(out_path, **{k: v.detach().numpy() for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    # the ranks meet through a file beside the output, not a TCP port that
    # another process could take between its choice and its use
    store = os.path.abspath(sys.argv[1]) + ".rendezvous"
    try:
        mp.spawn(_rank, args=(store, sys.argv[1]), nprocs=WORLD)
    finally:
        if os.path.exists(store):
            os.remove(store)
