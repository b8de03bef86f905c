"""chip_smoke.py's phase 18 (expert parallelism), rehearsed on the CPU.

18a's child runs here at toy widths (kimi-k2's family: a shared expert,
16 experts of 32, top-4) on a (1, 1) mesh of one gloo rank, and 18b's
four gloo ranks on a (2, 2) mesh at dbrx-132b's reduced widths, each in
its own processes as on the card; the CPU launches no kernel, so each
plain version a wrapper calls is counted as its launch through the
wrappers' own counter.  Then phase_ep's gates read those results, and
each gate is broken once.  The changed 17b gate is broken here too.
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

TOY = dict(
    EP_RUN=dict(arch="kimi-k2-1t-a32b", layers=1, batch=4, prompt=8,
                cache_len=12, steps=3, gate_rows=2, gate_cf=8.0,
                gate_max_cf=24.0,
                cfg=dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=32, d_ff=64, n_experts=16,
                         experts_per_token=4, moe_d_ff=32, dtype="float32")),
    EP_RANKS=dict(arch="dbrx-132b", shape=[2, 2], batch=4, seq=8,
                  capacity_factor=8.0))

_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
from repro_torch.kernels._launches import count_launch
from repro_torch.kernels.moe_gmm import ops as mg


def counted():
    plain = mg.gmm_ref
    def call(*a, **k):
        count_launch(mg.gmm)
        return plain(*a, **k)
    mg.gmm_ref = call


def toy(values):
    for k, v in values.items():
        setattr(chip_smoke, k, v)
    chip_smoke.EP_RANKS["shape"] = tuple(chip_smoke.EP_RANKS["shape"])


def counted_rank(rank, store, out, device):
    counted()
    toy(json.loads({toy!r}))
    chip_smoke._ep_rank(rank, store, out, device)


if __name__ == "__main__":
    counted()
    toy(json.loads({toy!r}))
    if sys.argv[1] == "18a":
        sys.exit(chip_smoke.ep_child(sys.argv[2], "cpu"))
    sys.exit(chip_smoke.ep_ranks_child(sys.argv[2], "cpu", counted_rank))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(18a's result, 18b's), from children run at once."""
    tmp = tmp_path_factory.mktemp("ep")
    script = tmp / "child.py"
    script.write_text(_CHILD.format(root=str(ROOT), toy=json.dumps(TOY)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {tag: subprocess.Popen(
        [sys.executable, str(script), tag, str(tmp / f"{tag}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag in ("18a", "18b")}
    for proc in procs.values():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    return tuple(json.loads((tmp / f"{tag}.json").read_text())
                 for tag in ("18a", "18b"))


@pytest.fixture
def toy(monkeypatch):
    for k, v in TOY.items():
        monkeypatch.setattr(chip_smoke, k, v)
    monkeypatch.setitem(chip_smoke.EP_RANKS, "shape", (2, 2))


def test_phase_18a_runs_every_moe_call_on_ep(results):
    r = results[0]
    t = TOY["EP_RUN"]
    calls = t["layers"] * (1 + t["steps"])
    assert r["ep_calls"] == calls
    assert r["counts"]["moe_gmm"] == r["launches"] == 3 * calls
    # toy capacities: prefill 32 tokens x top-4, decode 4 x 4, one rank
    assert r["drops"]["prefill"]["c_send"] == [160]
    assert r["drops"]["prefill"]["c_loc"] == [16]
    assert r["drops"]["decode"]["c_send"] == [24]
    assert r["drops"]["decode"]["c_loc"] == [8]
    assert r["gmm"]["worst"] <= 1.0 and r["finite"]
    assert r["gate"]["ep_drops"] == r["gate"]["sort_drops"] == 0
    assert r["gate"]["rel"] <= 1e-5          # f32 on the CPU


def test_phase_18b_ranks_equal_the_sort_path(results):
    ranks = results[1]
    assert sorted(r["rank"] for r in ranks) == [0, 1, 2, 3]
    for r in ranks:
        assert r["ep_calls"] == 1 and r["launches"] == 3 and not r["drops"]
        assert r["placed"]
        assert r["err"] <= 1e-5 and r["aux_err"] <= 1e-6


def test_phase_18_gates(results, toy, monkeypatch):
    a, b = results
    by_flag = {"--phase-18a": a, "--phase-18b": b}
    monkeypatch.setattr(chip_smoke, "_child", lambda flag, tag: by_flag[flag])
    assert chip_smoke.phase_ep() == dict(a=a, b=b)

    def broken(which, change, match):
        r = copy.deepcopy(by_flag)
        change(r[which])
        monkeypatch.setattr(chip_smoke, "_child", lambda flag, tag: r[flag])
        with pytest.raises(RuntimeError, match=match):
            chip_smoke.phase_ep()

    def launches(r):
        r["counts"]["moe_gmm"] -= 1
    broken("--phase-18a", lambda r: r.update(ep_calls=r["ep_calls"] - 1),
           "18a")
    broken("--phase-18a", launches, "18a")
    broken("--phase-18a", lambda r: r["gmm"].update(worst=1.5), "18a")
    broken("--phase-18a", lambda r: r["gmm"].update(rel=0.02), "18a")
    broken("--phase-18a", lambda r: r.update(finite=False), "18a")
    broken("--phase-18a", lambda r: r["gate"].update(sort_drops=1), "18a")
    broken("--phase-18a", lambda r: r["gate"].update(ep_drops=1), "18a")
    broken("--phase-18a", lambda r: r["gate"].update(rel=0.02), "18a")

    def card_paths(r):      # on the card each launch's path is gated
        r["prefill_gmm"] = {}
        r["paths"] = dict.fromkeys(r["paths"], 0)
    broken("--phase-18a", card_paths, "18a")
    broken("--phase-18b", lambda r: r[0].update(ep_calls=0), "18b")
    broken("--phase-18b", lambda r: r[1].update(launches=2), "18b")
    broken("--phase-18b", lambda r: r[2].update(drops=1), "18b")
    broken("--phase-18b", lambda r: r[3].update(err=1e-3), "18b")
    broken("--phase-18b", lambda r: r[3].update(aux_err=1e-3), "18b")
    broken("--phase-18b", lambda r: r[0].update(placed=False), "18b")
    broken("--phase-18b", lambda r: r.pop(), "18b")


def test_phase_17b_gates_the_ep_cell(monkeypatch):
    def cell(change, a2a):
        return {"report": {"arch": "dbrx-132b", "shape": "prefill_32k",
                           "mesh": "16x16", "ok": True, "peak_bytes": 2.0,
                           "flops_dev": 1.0, "bytes_dev": 1.0,
                           "coll_dev": a2a,
                           "coll_breakdown": {"all-to-all": a2a},
                           "dominant": "memory", "compute_s": 0.0,
                           "memory_s": 1.0, "collective_s": 0.0,
                           "useful_fraction": 0.5},
                "details": {"param_bytes": 8, "param_bytes_implied": 8,
                            "kernels": {}}, "changes": change,
                "wall_s": 1.0}
    good = [cell({}, 5.0), cell({"moe_impl": "sort"}, 0.0)]
    monkeypatch.setattr(chip_smoke, "_child", lambda *a: good)
    assert chip_smoke.phase_dryrun() == good
    for bad in ([cell({}, 0.0), good[1]],
                [good[0], cell({"moe_impl": "sort"}, 1.0)]):
        monkeypatch.setattr(chip_smoke, "_child", lambda *a, c=bad: c)
        with pytest.raises(RuntimeError, match="17b"):
            chip_smoke.phase_dryrun()
