"""chip_smoke.py's phase 17 (the pod tooling), rehearsed on the CPU.

17a's child runs here at toy widths on a (1, 1) mesh of one gloo rank
(in its own process, as on the card, where it is one NCCL rank); the CPU
launches no kernel, so each plain version a wrapper calls is counted as
its launch through the wrappers' own counter.  Then phase_mesh's and
phase_dryrun's gates read that result, and each gate is broken once.
17b's cells themselves are tests/test_torch_dryrun.py's.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SMALL = dict(vocab_size=512, d_model=128, n_heads=4, n_kv_heads=2,
             head_dim=32, d_ff=256, dtype="float32")
TOY = dict(
    MESH_TRAIN=dict(arch="qwen2-0.5b", layers=2, steps=2, batch=4, seq=32,
                    cfg=SMALL),
    MESH_MOE=dict(arch="dbrx-132b", batch=4, seq=16),
    MESH_SERVE=dict(arch="qwen3-4b", layers=2, batch=2, prompt=8,
                    cache_len=16, steps=3, cfg=SMALL))

_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
from repro_torch.kernels._launches import count_launch
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.flash_attention import ops as fl
from repro_torch.kernels.moe_gmm import ops as mg

def counted(mod, name, op):
    plain = getattr(mod, name)
    def call(*a, **k):
        count_launch(op)
        return plain(*a, **k)
    setattr(mod, name, call)

counted(fl, "flash_attention_ref", fl.flash_attention)
counted(dec, "decode_attention_ref", dec.decode_attention)
for name in ("gmm_ref", "gmm_dx_ref", "gmm_dw_ref"):
    counted(mg, name, mg.gmm)
for k, v in json.loads(sys.argv[2]).items():
    setattr(chip_smoke, k, v)
sys.exit(chip_smoke.mesh_child(sys.argv[1], "cpu"))
"""


@pytest.fixture(scope="module")
def result_17a(tmp_path_factory):
    out = tmp_path_factory.mktemp("pod") / "17a.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run(
        [sys.executable, "-c", _CHILD.format(root=str(ROOT)), str(out),
         json.dumps(TOY)], env=env, capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture
def toy(monkeypatch):
    for k, v in TOY.items():
        monkeypatch.setattr(chip_smoke, k, v)


def test_phase_17a_mesh_runs_equal_plain_runs_bit_for_bit(result_17a):
    for name in ("train", "moe", "serve"):
        r = result_17a[name]
        assert all(r["same"].values()), (name, r["same"])
        assert r["plain_counts"] == r["mesh_counts"], name
    assert result_17a["train"]["mesh_counts"]["flash_attention"] == 2
    assert result_17a["serve"]["mesh_counts"]["decode_attention"] == 6
    assert len(result_17a["train"]["mesh_step_ms"]) == 2


def test_phase_17a_gates(result_17a, toy, monkeypatch):
    monkeypatch.setattr(chip_smoke, "_child", lambda *a: result_17a)
    assert chip_smoke.phase_mesh() is result_17a

    def broken(change):
        r = copy.deepcopy(result_17a)
        change(r)
        monkeypatch.setattr(chip_smoke, "_child", lambda *a: r)
        with pytest.raises(RuntimeError, match="17a"):
            chip_smoke.phase_mesh()

    broken(lambda r: r["train"]["same"].update(losses=False))
    broken(lambda r: r["serve"]["same"].update(tokens=False))
    broken(lambda r: r["moe"]["mesh_counts"].update(
        moe_gmm=r["moe"]["mesh_counts"]["moe_gmm"] + 1))

    def both(r, key, n):
        for tag in ("plain_counts", "mesh_counts"):
            r["serve"][tag][key] = n
    broken(lambda r: both(r, "decode_attention", 5))


def test_phase_17b_gates(monkeypatch):
    cell = {"report": {"arch": "qwen3-4b", "shape": "decode_32k",
                       "mesh": "16x16", "ok": True, "peak_bytes": 2.0,
                       "flops_dev": 1.0, "bytes_dev": 1.0,
                       "coll_breakdown": {}, "dominant": "memory",
                       "compute_s": 0.0, "memory_s": 1.0,
                       "collective_s": 0.0, "useful_fraction": 0.5},
            "details": {"param_bytes": 8, "param_bytes_implied": 8,
                        "kernels": {}}, "wall_s": 1.0}
    monkeypatch.setattr(chip_smoke, "_child", lambda *a: [cell])
    assert chip_smoke.phase_dryrun() == [cell]
    for change in ({"ok": False}, None):
        bad = copy.deepcopy(cell)
        if change:
            bad["report"].update(change)
        else:
            bad["details"]["param_bytes"] = 9
        monkeypatch.setattr(chip_smoke, "_child", lambda *a: [bad])
        with pytest.raises(RuntimeError, match="17b"):
            chip_smoke.phase_dryrun()
