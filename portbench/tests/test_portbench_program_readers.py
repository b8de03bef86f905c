"""The readers of the program's own spans, events and MoE counts
(``repro_torch/trace.py``), on a made-up tracer and device trace."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import loop as L
from portbench.harness import spec as S
from portbench.harness.trace import DeviceTrace
from repro_torch import trace as T

MS = 10 ** 6
S_NS = 10 ** 9
READERS = ["queue_wait_p95_ms", "step_host_ms", "decode_sync_ms",
           "idle_share.enqueue", "idle_share.engine", "moe_drop_share"]
EPOCH = 1_700_000_000 * S_NS      # the epoch's ns at perf_counter 0
ENQUEUE = ("serve.step.enqueue", "serve.prefill.enqueue")


class Clocks:
    """perf_counter_ns set by hand; the wall clock that far from the epoch
    plus a drift that the test moves between ticks."""

    def __init__(self):
        self.t = 0
        self.drift = 0

    def perf(self):
        return self.t

    def wall(self):
        return EPOCH + self.t + self.drift


def decode_tick(tr, c, t0, drift, *, grow=0, tables=0, enqueue=0, sync=0,
                emit=0, moe=()):
    """One decode tick from perf time ``t0``: 0.1 ms of expiry, then the
    step's parts (ns), each MoE count of ``moe`` stashed in its enqueue."""
    c.t, c.drift = t0, drift
    tr.open_tick(1)
    tr.open("serve.expire", 1)
    c.t += MS // 10
    tr.close()
    tr.open("serve.step", 1)
    tr.open("serve.step.grow", 1)
    c.t += grow
    tr.lap("serve.step.tables")
    c.t += tables
    tr.lap("serve.step.enqueue", (False,))
    for counts, cap in moe:
        tr.moe(torch.tensor(counts), cap, sum(counts) // 2)
    c.t += enqueue
    tr.lap("serve.step.sync")
    c.t += sync
    tr.lap("serve.step.emit")
    c.t += emit
    tr.close()
    tr.close((4,))
    tr.close_tick((0, 4, 0, 4))


def prefill_tick(tr, c, t0, drift, *, enqueue, moe=(), rids=()):
    c.t, c.drift = t0, drift
    tr.open_tick(1)
    tr.open("serve.admit", 1)
    tr.open("serve.prefill", 1)
    tr.events("request.admit", 1, rids)
    tr.open("serve.prefill.enqueue", 1)
    for counts, cap in moe:
        tr.moe(torch.tensor(counts), cap, sum(counts) // 2)
    c.t += enqueue
    tr.lap("serve.prefill.splice")
    c.t += MS
    tr.lap("serve.prefill.sync")
    c.t += MS
    tr.close()
    tr.events("request.first_token", 1, rids)
    tr.close((len(rids), 8, 8, tuple(rids)))
    tr.close((len(rids),))
    tr.close_tick((len(rids), 0, 0, len(rids)))


@pytest.fixture
def tracer(monkeypatch):
    c = Clocks()
    tr = T.Tracer(capacity=1 << 10, moe_capacity=1 << 6, clock=c.perf,
                  wall=c.wall)
    monkeypatch.setattr(T, "TRACER", tr)
    return tr, c


def context(trace=None):
    """Window (1 s, 20 s] on the perf clock; tracing from 10 s."""
    return SimpleNamespace(rec=L.Record(t_open=1.0, t_close=20.0),
                           traced_from_ns=10 * S_NS, trace=trace, cfg={})


def read(name, ctx):
    return S.metric_reader(name).read(ctx)


def test_host_readers_take_the_window_before_tracing(tracer):
    tr, c = tracer
    # before the window, in it (three), and in the traced part
    decode_tick(tr, c, S_NS // 2, 0, grow=9 * MS, sync=9 * MS)
    for k, t in enumerate((2, 3, 4)):
        decode_tick(tr, c, t * S_NS, 0, grow=MS * (k + 1), tables=MS // 2,
                    enqueue=20 * MS, sync=MS * (k + 1), emit=MS)
    decode_tick(tr, c, 11 * S_NS, 0, grow=9 * MS, sync=9 * MS)
    ctx = context()
    # grow 1, 2, 3 + tables 0.5 + emit 1 (the step's own time is 0 here)
    assert read("step_host_ms", ctx) == pytest.approx(2 + 0.5 + 1)
    assert read("decode_sync_ms", ctx) == pytest.approx(2.0)


def test_queue_wait_is_submit_to_the_start_of_the_bucket(tracer):
    tr, c = tracer
    for rid in range(20):
        c.t = 2 * S_NS + rid * 100 * MS
        tr.event("request.submit", 1, rid)
        c.t += (rid + 1) * MS
        tr.events("request.admit", 1, [rid])
    # admitted before the window or while tracing: left out
    for rid, t in ((100, S_NS // 4), (101, 11 * S_NS)):
        c.t = t
        tr.event("request.submit", 1, rid)
        c.t += 500 * MS
        tr.events("request.admit", 1, [rid])
    # a request of another engine with the same rid
    c.t = 5 * S_NS
    tr.event("request.submit", 2, 3)
    c.t += 900 * MS
    tr.events("request.admit", 2, [3])
    want = np.percentile(np.arange(1, 21, dtype=float).tolist() + [900.0],
                         95)
    assert read("queue_wait_p95_ms", context()) == pytest.approx(want)


def test_drop_share_counts_decode_steps_in_the_window(tracer):
    tr, c = tracer
    # two layers a step: 4 experts, 8 rows top-2 = 16 pairs, capacity 4
    decode_tick(tr, c, 2 * S_NS, 0, enqueue=MS,
                moe=[([6, 4, 4, 2], 4), ([4, 4, 4, 4], 4)])
    decode_tick(tr, c, 3 * S_NS, 0, enqueue=MS,
                moe=[([8, 0, 4, 4], 4), ([5, 5, 5, 1], 4)])
    # a prefill's calls and a step after the window: left out
    prefill_tick(tr, c, 4 * S_NS, 0, enqueue=MS, moe=[([16, 0, 0, 0], 4)])
    decode_tick(tr, c, 21 * S_NS, 0, enqueue=MS, moe=[([16, 0, 0, 0], 4)])
    dropped = 2 + 0 + 4 + 3
    assert read("moe_drop_share", context()) == pytest.approx(
        100.0 * dropped / 64)


def device_ops(t0, t1, gaps, copies):
    """Busy ops over ``[t0, t1]`` but for ``gaps``, and the DtoH copies
    ending at ``copies``."""
    ops, t = [], t0
    for a, b in sorted(gaps):
        ops.append(("k", t, a))
        t = b
    ops.append(("k", t, t1))
    return ops + [("Memcpy DtoH (Device -> Pageable)", e - 2000, e)
                  for e in copies]


def test_idle_split_follows_each_tick_and_the_device_clock(tracer):
    """Ticks at perf 11 s, 12 s and 13 s.  The second's wall clock reads
    3 ms more than the first's (its own pair of host clocks places it),
    and the device's clock runs 1 ms behind the host's by the second tick
    and 1.2 ms by the third (each tick's argmax copy places it)."""
    tr, c = tracer
    wall = (0, 3 * MS, 0)
    dev = (0, -MS, -12 * MS // 10)
    for t0, d in zip((11 * S_NS, 12 * S_NS), wall):
        decode_tick(tr, c, t0, d, grow=MS, enqueue=10 * MS, sync=2 * MS,
                    emit=MS)
    prefill_tick(tr, c, 13 * S_NS, 0, enqueue=5 * MS)

    def at(k, t):
        """Perf time ``t`` of tick ``k`` on the device trace's clock."""
        return EPOCH + t + wall[k] + dev[k]
    e1 = 11 * S_NS + MS // 10 + MS          # enqueue starts, perf
    e2 = 12 * S_NS + MS // 10 + MS
    lag = 20_000                            # copy's end to sync's end
    copies = [at(0, e1 + 12 * MS) - lag, at(1, e2 + 12 * MS) - lag,
              at(2, 13 * S_NS + 7 * MS) - lag]
    gaps = [(at(0, e1 + 5 * MS), at(0, e1 + 9 * MS)),    # enqueue, 4 ms
            (copies[0], copies[0] + MS // 2),            # engine, 0.5
            (at(1, e2 + MS // 2), at(1, e2 + 12 * MS // 10)),  # enqueue
            (at(1, e2 + 103 * MS // 10), at(1, e2 + 109 * MS // 10)),
            (at(2, 13 * S_NS + 2 * MS), at(2, 13 * S_NS + 3 * MS))]
    t_trace0, t_trace1 = at(0, 11 * S_NS - MS), at(2, 13 * S_NS + 10 * MS)
    ctx = context(DeviceTrace(t_trace0, t_trace1,
                              device_ops(t_trace0, t_trace1, gaps, copies)))
    window = t_trace1 - t_trace0
    enqueue, engine = (4 + 0.7 + 1) * MS, (0.5 + 0.6) * MS
    assert read("idle_share.enqueue", ctx) == pytest.approx(
        100 * enqueue / window)
    assert read("idle_share.engine", ctx) == pytest.approx(
        100 * engine / window)
    assert read("idle_share.enqueue", ctx) + read("idle_share.engine", ctx) \
        == pytest.approx(read("idle_share", ctx))
    # the pairs of host clocks alone file the second tick's gaps the other
    # way round
    snap = T.TRACER.snapshot()
    ticks = [t.i for t in snap.named("serve.tick")]
    assert snap.inside(ENQUEUE, [gaps[2][0], gaps[3][0]],
                       {i: 0 for i in ticks}) == [False, True]


@pytest.mark.parametrize("rate", [0.0015, 0.01, -0.016])
def test_drift_follows_the_copies_past_other_copies(tracer, rate):
    """40 decode ticks 28 ms apart, the device's clock falling behind the
    host's by ``rate`` from the tenth (an H100's did by 0.15% and 1%, and
    ran ahead by 1.6%), each tick's argmax copy 10-55 us before its sync
    span ends and the next step's first copy 1.1 ms after it."""
    tr, c = tracer
    ends, want = [], []
    rng = np.random.default_rng(5)
    for k in range(40):
        t0 = 11 * S_NS + k * 28 * MS
        decode_tick(tr, c, t0, 0, grow=MS, enqueue=20 * MS, sync=2 * MS,
                    emit=MS)
        d = -int(rate * max(0, k - 10) * 28 * MS)
        lag = int(rng.integers(10_000, 55_000))
        copy = EPOCH + t0 + MS // 10 + 23 * MS + d - lag
        ends += [copy, copy + 11 * MS // 10]
        want.append(d - lag)
    t_trace0, t_trace1 = EPOCH + 11 * S_NS - MS, EPOCH + 12 * S_NS + 200 * MS
    dt = DeviceTrace(t_trace0, t_trace1, device_ops(t_trace0, t_trace1, [],
                                                    ends))
    got = S.metric_reader("idle_share.enqueue").drift(T.TRACER.snapshot(), dt)
    ticks = [t.i for t in T.TRACER.snapshot().named("serve.tick")]
    assert [got[i] for i in ticks] == want


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_tracer(name, tracer, monkeypatch):
    tr, c = tracer
    decode_tick(tr, c, 2 * S_NS, 0, enqueue=MS, moe=[([2, 2], 8)])
    dt = DeviceTrace(EPOCH, EPOCH + 20 * S_NS, [("k", EPOCH, EPOCH + MS)])
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read(name, context(dt)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_an_empty_tracer(name, tracer):
    dt = DeviceTrace(EPOCH, EPOCH + 20 * S_NS, [("k", EPOCH, EPOCH + MS)])
    assert read(name, context(dt)) is None
