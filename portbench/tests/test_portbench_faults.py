"""A whole run at a reduced size on the CPU, past the look for a card: the
check passes the sound program and fails it with the timed path broken
underneath, once for each fault a served model's cell can have (a token
altered where it is produced; a step that returns its state unchanged).
The cells' own limits judge."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from portbench.harness import bench
from portbench.harness import spec as S

TINY = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 32, "d_ff": 192, "moe_d_ff": 96, "vocab_size": 256,
        "dtype": "float32"}
MIX = {"clients": 4, "cache_len": 256,
       "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.8,
                  "min": 8, "max": 64},
       "output": {"dist": "uniform", "min": 4, "max": 24}}
# A dense model's cell, which the benchmark has none of yet: the dense
# family's configuration file under the chat mix, judged by the widest gap
# at the limit its last cell had (PERF.md)
DENSE_LIMITS = {"gap": 0.3,
                "sample": {"tokens": 400, "max_requests": 4,
                           "per_request": 100}}
# (cell, clients): 12 rows of dbrx-132b's decode can lose pairs to capacity
# (C 8), so the recorded step is followed whole; 4 cannot, so each
# request's decode steps are followed alone; the dense cell is
# teacher-forced
CELLS = [("dbrx-132b.chat", 12), ("dbrx-132b.chat", 4), ("dense.chat", 4)]


def resolve(name: str) -> S.Cell:
    spec = S.load_spec()
    if name != "dense.chat":
        return S.resolve_cell(spec, name)
    c = S.resolve_cell(spec, "dbrx-132b.chat")
    return dataclasses.replace(
        c, name=name, config_name="mistral-large-123b",
        config=S.load_json(S.BENCH_DIR / "configs"
                           / "mistral-large-123b.json"),
        limits=DENSE_LIMITS)


def altered_token(bundle, engine):
    """Every decode step serves each row's second-best token."""
    decode = bundle.decode_paged

    def call(params, cache, batch):
        logits, new = decode(params, cache, batch)
        logits = logits.clone()
        logits.scatter_(1, logits.argmax(-1, keepdim=True), float("-inf"))
        return logits, new
    bundle.decode_paged = call


def state_unchanged(bundle, engine):
    """Every decode step writes its keys and values to a copy of the pool
    and hands the engine back the pool as it was."""
    decode = bundle.decode_paged

    def call(params, cache, batch):
        scratch = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
        logits, new = decode(params, scratch, batch)
        return logits, dict(new, k=cache["k"], v=cache["v"])
    bundle.decode_paged = call


def run(cell, patch=None, seed: int = 3_000_000_019):
    name, clients = cell
    c = resolve(name)
    return bench.run_cell(c, seed, 0.6, False, t_start=time.perf_counter(),
                          device="cpu", config=TINY,
                          mix=dict(MIX, clients=clients), patch=patch)


def cell_id(cell) -> str:
    return f"{cell[0]}-{cell[1]}"


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_the_sound_program_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["compared_tokens"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.parametrize("fault", [altered_token, state_unchanged],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = run(cell, fault)
    assert not out["correct"], out["checks"]


def test_a_run_with_nothing_to_compare_is_not_correct():
    c = S.resolve_cell(S.load_spec(), "dbrx-132b.chat")
    from portbench.harness.check import Readings, judge
    assert judge(Readings(), c.limits) == (False, {})
    assert torch.get_num_threads() == 1


def test_the_widest_gap_leaves_out_tokens_at_a_near_tie():
    from portbench.harness.check import Readings, judge
    r = Readings()
    r.add_gap("f32", torch.tensor([0.1, 0.9, 0.2]),
              torch.tensor([False, True, False]))
    r.tokens = 3
    n = r.numbers("f32")
    assert n["gap"] == pytest.approx(0.2) and n["gap_all"] == \
        pytest.approx(0.9) and n["tie_share"] == pytest.approx(1 / 3)
    assert judge(r, {"gap": 0.5})[0]
    # every token at a near-tie: no widest gap to judge, not correct
    every = Readings()
    every.add_gap("f32", torch.tensor([0.1]), torch.tensor([True]))
    every.tokens = 1
    assert judge(every, {"gap": 0.5}) == (False, {})
