"""The port's dry run on the fake 256-rank production mesh: cells run,
rank 0's param bytes equal what the specs imply exactly, local flops are
counted once per device, the depth extrapolation equals a deeper run, the
roofline formula equals ``repro``'s, and the report agrees with
``repro``'s own dry run where the two can agree."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.core.cost_backend import TPU_ROOFLINE
from repro.launch.roofline import CellReport as JaxCellReport
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.launch.roofline import (
    TPU_V5E,
    CellReport,
    LocalOpCounter,
    roofline_terms,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# repro's dry run against the port's on qwen3-4b x decode_32k at depth 2,
# flops_dev port / repro: 1.1395 measured (the port's eager ops against
# XLA's fused HLO, and DTensor's collectives against the SPMD
# partitioner's); the bound leaves room for either to move a little
FLOPS_RATIO = (0.95, 1.30)


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    """The fake process group lives as long as the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_report_keys_equal_repros():
    assert list(CellReport("a", "s", "m", "k", True).to_dict()) == \
        list(JaxCellReport("a", "s", "m", "k", True).to_dict())


@pytest.mark.parametrize("args", [(1e15, 3e12, 4e11, 256),
                                  (2.5e14, 7.1e11, 0.0, 512),
                                  (123456789.0, 98765.0, 4321.0, 1)])
def test_three_terms_with_tpu_constants_equal_repros(args):
    mine = roofline_terms(*args, hw=TPU_V5E)
    ref = TPU_ROOFLINE.roofline_terms(*args)
    assert (mine.compute_s, mine.memory_s, mine.collective_s,
            mine.dominant) == (ref.compute_s, ref.memory_s,
                               ref.collective_s, ref.dominant)


def test_local_flops_are_counted_once_per_device():
    """(256, 128, 4096) x (4096, 11008) bf16, the batch split 16 ways over
    data and the columns 16 ways over model: rank 0 multiplies (16, 128,
    4096) by (4096, 688), 11,542,724,608 flops, the global op's
    2,954,937,499,648 / 256.  A FlopCounterMode outside DTensor would add
    the global op."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dryrun.fake_process_group(256)
    mesh = make_production_mesh(device_type="cuda")
    x = DTensor.from_local(torch.empty(16, 128, 4096, dtype=torch.bfloat16,
                                       device="meta"),
                           mesh, [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(4096, 688, dtype=torch.bfloat16,
                                       device="meta"),
                           mesh, [Replicate(), Shard(1)], run_check=False)
    counter = LocalOpCounter()
    with counter:
        y = x @ w
    assert tuple(y.shape) == (256, 128, 11008)
    assert counter.c.flops == 11_542_724_608 == 2 * 256 * 128 * 4096 \
        * 11008 // 256
    assert counter.c.bytes_collective == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _calls():
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.moe_gmm import ops as mg
    from repro_torch.kernels.ssd import ops as ssd
    i32 = torch.int32
    return {
        "decode_attention": (dec.decode_attention, lambda: (
            _meta(2, 8, 128), _meta(2, 64, 2, 128), _meta(2, 64, 2, 128),
            _meta(2, dtype=i32)), [(2, 8, 128)],
            4 * 8 * 128 * 2 * 64,
            2 * 2 * 8 * 128 * 2 + 2 * 2 * 64 * 2 * 128 * 2 + 4 * 2),
        "paged_decode_attention": (dec.paged_decode_attention, lambda: (
            _meta(2, 8, 128), _meta(9, 16, 2, 128), _meta(9, 16, 2, 128),
            _meta(2, 4, dtype=i32), _meta(2, dtype=i32)), [(2, 8, 128)],
            4 * 8 * 128 * 2 * 64,
            2 * 2 * 8 * 128 * 2 + 2 * 2 * 64 * 2 * 128 * 2 + 4 * 2
            + 4 * 2 * 4),
        "flash_attention": (fl.flash_attention, lambda: (
            _meta(2, 16, 8, 128), _meta(2, 16, 2, 128),
            _meta(2, 16, 2, 128)), [(2, 16, 8, 128)],
            4 * 128 * 8 * 2 * (16 * 17 // 2),
            (2 * 2 * 16 * 8 * 128 + 2 * 2 * 16 * 2 * 128) * 2),
        "ssd_scan": (ssd.ssd_scan, lambda: (
            _meta(2, 32, 4, 64), _meta(2, 32, 4, dtype=torch.float32),
            _meta(4, dtype=torch.float32), _meta(2, 32, 1, 64),
            _meta(2, 32, 1, 64), 16), [(2, 32, 4, 64), (2, 4, 64, 64)],
            4 * 2 * 32 * 4 * 64 * 64,
            (2 * 2 * 32 * 4 * 64 + 2 * 2 * 32 * 64) * 2 + 2 * 32 * 4 * 4
            + 4 * 4 + 2 * 4 * 64 * 64 * 4),
        "gmm": (mg.gmm, lambda: (_meta(4, 8, 64), _meta(4, 64, 32)),
                [(4, 8, 32)], 2 * 4 * 8 * 64 * 32,
                (4 * 8 * 64 + 4 * 64 * 32 + 4 * 8 * 32) * 2),
    }


@pytest.mark.parametrize("name", ["decode_attention",
                                  "paged_decode_attention",
                                  "flash_attention", "ssd_scan", "gmm"])
def test_kernel_wrappers_take_their_branch_without_data(name):
    """A wrapper given tensors without data returns empties of the
    kernel's outputs after its argument checks, counts no launch and
    reports its bound's flops and bytes; bad arguments still raise."""
    from repro_torch.kernels._launches import recording_fake_calls

    op, args, shapes, flops, nbytes = _calls()[name]
    before = op.launches
    seen = []
    with recording_fake_calls(lambda *r: seen.append(r)):
        out = op(*args())
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(t.shape) for t in outs] == shapes
    assert all(t.is_meta for t in outs)
    assert op.launches == before
    assert seen == [(name, flops, nbytes)]
    bad = list(args())
    bad[0] = bad[0].float()       # a dtype the checks refuse
    with pytest.raises(ValueError):
        op(*bad)


def test_ep_moe_layer_counts_its_all_to_all_bytes():
    """One EP MoE layer on the fake (16, 16) mesh, x (32, 64, 64) bf16:
    each rank holds 2 x 4 tokens (batch over data, sequence over model),
    so c_send is ceil8(int(8 * 2 / 16 * 1.25)) = 8 rows for each of the
    16 ranks of "model".  The counter sees what those imply: the rows out
    and back (2 x 16 x 8 x 64 bf16) and their int32 expert ids once; the
    two load-balance means of 16 f32 over data and model; and gathers of
    the FSDP-split router and expert weights and of the output's
    sequence."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe

    dryrun.fake_process_group(256)
    mesh = make_production_mesh(device_type="cuda")
    cfg = ModelConfig(name="ep", family="moe", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                      n_experts=16, experts_per_token=2, moe_d_ff=32,
                      dtype="bfloat16", moe_impl="ep_a2a")
    rules = sh.default_rules()
    full = {k: torch.empty(v.shape, dtype=torch.bfloat16, device="meta")
            for k, v in moe.init_moe(torch.Generator(), cfg).items()}
    counter = LocalOpCounter()
    with sh.axis_rules(rules, mesh):
        p = sh.distribute_params(full, moe.moe_specs(cfg), rules, mesh)
        x = DTensor.from_local(torch.empty(2, 64, 64, dtype=torch.bfloat16,
                                           device="meta"),
                               mesh, [Shard(0), Replicate()],
                               run_check=False)
        with counter:
            y, aux = moe.moe_block(p, x, cfg)
    assert tuple(y.shape) == (32, 64, 64)
    assert tuple(y.placements) == (Shard(0), Replicate())
    rows = 16 * 8
    coll = counter.c.coll_breakdown
    assert coll["all-to-all"] == 2 * rows * 64 * 2 + rows * 4
    assert coll["all-reduce"] == 2 * 2 * 16 * 4
    # router (4, 16) and each expert matrix (1, 4, 32) over "data"; the
    # output's (2, 4, 64) over "model"
    assert coll["all-gather"] == (4 * 16 + 3 * 4 * 32 + 2 * 4 * 64) * 2


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_depth_two_qwen3_cells_run_with_exact_param_bytes(shape):
    details = {}
    rep = dryrun.run_cell("qwen3-4b", shape, False, verbose=False,
                          cfg_overrides={"n_layers": 2}, details=details)
    assert rep.ok and rep.error == ""
    assert details["param_bytes"] == details["param_bytes_implied"]
    assert details["param_bytes"] > 0
    assert details["depths"] == [{"layers": 1}, {"layers": 2}]
    assert rep.flops_dev > 0 and rep.bytes_dev >= rep.bytes_dev_min > 0
    assert rep.peak_bytes >= rep.arg_bytes > 0
    assert rep.dominant in ("compute", "memory", "collective")
    kernels = details["kernels"]
    if shape == "decode_32k":
        # one decode-attention call a layer, no other kernel
        assert set(kernels) == {"decode_attention"}
        assert kernels["decode_attention"]["calls"] == 2
        assert "all-gather" in rep.coll_breakdown   # head_dim gathered
    else:
        # training takes chunked_attention (the flash kernel has no
        # backward): no kernel runs; the data-parallel grads reduce
        assert kernels == {}
        assert rep.coll_breakdown.get("reduce-scatter", 0) > 0
    assert rep.model_flops == dryrun._model_flops(
        dryrun.with_depth(get_config("qwen3-4b"), {"layers": 2}),
        SHAPES[shape])


@pytest.mark.parametrize("arch,shape,full", [
    ("qwen3-4b", "decode_32k", {"layers": 3}),
    ("zamba2-7b", "long_500k", {"groups": 2, "tail": 1}),
])
def test_depth_extrapolation_equals_a_deeper_run(arch, shape, full):
    """Every count taken linearly from the smallest depths equals the
    count of a run at the deeper depth, the peak within 1e-4."""
    cfg = dryrun.with_depth(get_config(arch), full)
    cell = SHAPES[shape]
    dryrun.fake_process_group(256)
    mesh = make_production_mesh(device_type="cuda")
    rules = rules_for(arch, multi_pod=False, global_batch=cell.global_batch)
    at, plan = dryrun.depth_plan(cfg)
    base, _ = dryrun._measure(dryrun.with_depth(cfg, at), cell, rules, mesh)
    steps = {k: dryrun._measure(dryrun.with_depth(cfg, v), cell, rules,
                                mesh)[0] for k, v in plan.items()}
    keys = sorted(set(base).union(*steps.values()))
    got = dryrun.extrapolate(
        dryrun._with_keys(base, keys),
        {k: dryrun._with_keys(v, keys) for k, v in steps.items()},
        dryrun.depth_knobs(cfg), at)
    want, _ = dryrun._measure(cfg, cell, rules, mesh)
    for k in keys:
        if k == "peak_bytes":
            assert math.isclose(got[k], want[k], rel_tol=1e-4), k
        else:
            assert got[k] == want.get(k, 0.0), k


def test_skipped_cell_is_ok():
    rep = dryrun.run_cell("qwen3-4b", "long_500k", False, verbose=False)
    assert rep.ok and rep.note.startswith("SKIPPED")


# repro's CLI on this jax builds its mesh with Explicit axes, which its
# own with_sharding_constraint refuses; tests/conftest.py's make_auto_mesh
# makes its meshes Auto, and so does this driver before calling the CLI
_REPRO_CLI = """
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=512")
import jax
_make = jax.make_mesh
def make_mesh(shape, axes, **kw):
    if hasattr(jax.sharding, "AxisType"):
        kw.setdefault("axis_types", (jax.sharding.AxisType.Auto,) * len(axes))
    return _make(shape, axes, **kw)
jax.make_mesh = make_mesh
from repro.launch import dryrun
sys.exit(dryrun.main(sys.argv[1:]))
"""


def test_agrees_with_repros_dry_run(tmp_path):
    """qwen3-4b x decode_32k at depth 2 in both packages: the argument
    bytes per device agree to the byte but for the cache's length, an
    int32 scalar in ``repro`` and a Python int in the port; the model
    flops are equal; flops_dev agree within FLOPS_RATIO."""
    out = tmp_path / "repro.jsonl"
    args = ["--arch", "qwen3-4b", "--shape", "decode_32k", "--config",
            json.dumps({"n_layers": 2}), "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", _REPRO_CLI, *args], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    ref = json.loads(out.read_text().splitlines()[-1])
    rep = dryrun.run_cell("qwen3-4b", "decode_32k", False, verbose=False,
                          cfg_overrides={"n_layers": 2})
    assert ref["ok"] and rep.ok
    assert rep.arg_bytes + 4 == ref["arg_bytes"]
    assert rep.model_flops == ref["model_flops"]
    ratio = rep.flops_dev / ref["flops_dev"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], ratio


def test_cli_appends_a_report_and_exits_zero(tmp_path):
    out = tmp_path / "port.jsonl"
    rc = dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                      "--config", json.dumps({"n_layers": 1}),
                      "--out", str(out)])
    assert rc == 0
    line = json.loads(out.read_text().splitlines()[-1])
    assert list(line) == list(JaxCellReport("a", "s", "m", "k",
                                            True).to_dict())
    assert line["ok"] and line["mesh"] == "16x16"


# last in the module: a group of another size replaces the 256-rank one,
# and DeviceMesh keeps the names of the groups it was built on
@pytest.mark.parametrize("multi_pod", [False, True])
def test_full_depth_param_bytes_are_exact_on_both_meshes(multi_pod):
    details = {}
    rep = dryrun.run_cell("qwen3-4b", "decode_32k", multi_pod,
                          verbose=False, details=details)
    assert rep.ok and rep.mesh == ("2x16x16" if multi_pod else "16x16")
    assert details["chips"] == (512 if multi_pod else 256)
    assert details["param_bytes"] == details["param_bytes_implied"]
