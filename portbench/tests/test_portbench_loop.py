"""The closed loop and the end-to-end arithmetic, on made-up timestamps."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import loop as L
from portbench.harness import traffic

CHAT = {"loop": "closed", "clients": 4, "cache_len": 256,
        "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.8,
                   "min": 8, "max": 64},
        "output": {"dist": "uniform", "min": 4, "max": 16}, "pool": 64}


def record() -> L.Record:
    """Window (10, 20].  Request 1: sent at 9, first token at 11 (a tick
    that also gave its second), then 12, 13.  Request 2: sent at 12,
    first at 14, then 21 (after the close).  Request 3: sent at 19.5,
    first at 20.5, in the drain.  Request 4: sent at 20 (at the close:
    not in the window)."""
    rec = L.Record(t_open=10.0, t_close=20.0)
    rec.sent = {
        1: L.Sent(1, prompt_len=100, max_new=4, t_submit=9.0, t_first=11.0),
        2: L.Sent(2, prompt_len=50, max_new=4, t_submit=12.0, t_first=14.0),
        3: L.Sent(3, prompt_len=30, max_new=4, t_submit=19.5,
                  t_first=20.5),
        4: L.Sent(4, prompt_len=10, max_new=4, t_submit=20.0),
    }
    rec.deliveries = [(11.0, 1, 2, None), (12.0, 1, 1, 1.0),
                      (13.0, 1, 1, 1.0), (14.0, 2, 1, None),
                      (21.0, 2, 1, 7.0), (20.5, 3, 1, None)]
    return rec


def test_output_tokens_count_ticks_that_ended_in_the_window():
    rec = record()
    assert L.output_tokens(rec) == 5
    assert L.output_tok_s(rec) == pytest.approx(0.5)


def test_ttft_runs_to_the_end_of_the_tick_for_requests_sent_in_window():
    rec = record()
    assert sorted(L.ttfts_s(rec)) == [1.0, 2.0]   # requests 3 and 2
    assert L.percentile([1.0, 2.0], 95) == pytest.approx(1.95)


def test_itl_gaps_include_zeros_for_tokens_of_one_tick():
    assert sorted(L.itls_s(record())) == [0.0, 1.0, 1.0]


def test_prompt_tokens_of_prefills_that_finished_in_the_window():
    assert L.prompt_tok_s(record()) == pytest.approx((100 + 50) / 10.0)


def test_attempted_and_failed():
    rec = record()
    assert L.attempted_failed(rec) == (2, 0)
    rec.sent[2].failed = True
    assert L.attempted_failed(rec) == (2, 1)
    rec.sent[3].t_first = None
    assert L.attempted_failed(rec) == (2, 2)


class FakeReq:
    def __init__(self, rid, prompt, max_new):
        self.rid, self.prompt, self.max_new = rid, prompt, max_new
        self.out = []
        self.expired = self.oom = self.rejected = False


class FakeEngine:
    """Admits every waiting request into a free slot (first token), then
    gives every active request one token; a request leaves at max_new."""

    def __init__(self, slots):
        self.active = [None] * slots
        self.waiting, self.finished = [], []

    def submit(self, req):
        self.waiting.append(req)
        return True

    def tick(self, now):
        admitted = 0
        for s in range(len(self.active)):
            if self.active[s] is None and self.waiting:
                r = self.waiting.pop(0)
                r.out.append(0)
                self.active[s] = r
                admitted += 1
        produced = 0
        for s, r in enumerate(self.active):
            if r is None:
                continue
            if len(r.out) < r.max_new:
                r.out.append(1)
                produced += 1
            if len(r.out) >= r.max_new:
                self.finished.append(r)
                self.active[s] = None
        return {"admitted": admitted, "produced": produced}

    def take_finished(self):
        out, self.finished = self.finished, []
        return out


def test_closed_loop_keeps_every_client_busy_and_stamps_ticks():
    now = [0.0]

    def clock():
        now[0] += 0.25
        return now[0]
    eng = FakeEngine(4)
    loop = L.ClosedLoop(eng, traffic.requests(CHAT, 7, 100), 4,
                        lambda i, d: FakeReq(i, d.prompt, d.max_new),
                        clock=clock)
    loop.start()
    loop.tick()
    loop.run_window(20.0)
    rec = loop.rec
    # every tick ends with 4 requests in flight or freshly sent
    assert all(r is not None for r in eng.active) or eng.waiting
    done = [s for s in rec.sent.values() if s.done]
    assert done and all(s.delivered == s.max_new for s in done)
    # a request's first tick gives it two tokens: one gap of 0
    assert 0.0 in L.itls_s(rec)
    assert all(t > 0 for t in L.ttfts_s(rec))
    assert L.attempted_failed(rec)[1] == 0
    assert rec.t_close == rec.ticks[-1][1]


def test_every_seed_gets_the_same_lengths_in_another_order():
    def lengths(seed, n=64):
        it = traffic.requests(CHAT, seed, 100)
        ds = [next(it) for _ in range(n + 4)][4:]
        return [len(d.prompt) for d in ds], [d.max_new for d in ds]
    a, b = lengths(1), lengths(2 ** 40 + 3)
    assert sorted(a[0]) == sorted(b[0]) and a[0] != b[0]
    assert sorted(a[1]) == sorted(b[1])
    assert lengths(1) == a


def test_first_requests_start_in_steady_state():
    it = traffic.requests(CHAT, 11, 100)
    first = [next(it) for _ in range(4)]
    full = traffic.quantiles(CHAT["output"], CHAT["pool"])
    assert all(1 <= d.max_new <= full.max() for d in first)
    assert all(d.prompt.dtype == np.int32 for d in first)


def test_quantiles_follow_the_distribution():
    q = traffic.quantiles({"dist": "lognormal", "median": 256, "sigma": 0.8,
                           "min": 32, "max": 1024}, 4096)
    assert q.min() >= 32 and q.max() <= 1024
    assert abs(np.median(q) - 256) <= 1
    u = traffic.quantiles({"dist": "uniform", "min": 8, "max": 32}, 2500)
    assert u.min() == 8 and u.max() == 32
    assert np.bincount(u)[8:].std() < 2


def test_a_mix_whose_requests_overflow_the_cache_is_refused():
    bad = dict(CHAT, cache_len=64)
    with pytest.raises(ValueError):
        traffic.check_mix(bad)


def test_the_dense_sample_caps_each_request_so_several_are_compared():
    from types import SimpleNamespace

    from portbench.harness.check import finished_sample
    rec = L.Record(t_open=10.0, t_close=20.0)
    for rid, n in enumerate((900, 500, 300, 200, 120, 80)):
        rec.sent[rid] = L.Sent(rid, prompt_len=10, max_new=n, t_submit=11.0,
                               t_last=15.0, done=True,
                               req=SimpleNamespace(out=[0] * n))
    rng = np.random.default_rng(0)
    picked = finished_sample(rec, rng, tokens=400, max_requests=4,
                             per_request=100)
    assert len(picked) == 4 and picked[0].rid == 0
    # uncapped, the longest request alone fills the sample
    assert len(finished_sample(rec, np.random.default_rng(0), 400, 4,
                               per_request=10 ** 6)) == 1
