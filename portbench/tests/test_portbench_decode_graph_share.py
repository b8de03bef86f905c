"""The reader of the decode graph's span (``decode_graph_share``), on a
made-up tracer: the ``model.decode.graph`` span that the LM bundle's
``decode_paged`` records under ``serve.step.enqueue``."""
from __future__ import annotations

import sys

import pytest

from portbench.tests.test_portbench_program_readers import (
    MS, S_NS, decode_tick, context, read, tracer)  # noqa: F401 (fixture)
from repro_torch import trace as T


def graph_tick(tr, c, t0, mode):
    """One decode tick from perf time ``t0`` whose 1 ms enqueue holds a
    ``model.decode.graph`` span of ``mode`` (none where ``mode`` is None)."""
    c.t = t0
    tr.open_tick(1)
    tr.open("serve.step", 1)
    tr.open("serve.step.enqueue", 1)
    c.t += MS
    if mode is not None:
        tr.record("model.decode.graph", c.t - MS, (mode, 1))
    tr.lap("serve.step.sync")
    c.t += MS
    tr.close()
    tr.close((4,))
    tr.close_tick((0, 4, 0, 4))


def test_graph_share_counts_the_window_steps_that_replayed(tracer):
    tr, c = tracer
    # the capture before the window; in it 3 replays, an eager step and a
    # step without the span; a replay after it
    graph_tick(tr, c, S_NS // 2, "capture")
    for k, mode in enumerate(("replay", "eager", "replay", None, "replay")):
        graph_tick(tr, c, (2 + k) * S_NS, mode)
    graph_tick(tr, c, 21 * S_NS, "replay")
    assert read("decode_graph_share", context()) == pytest.approx(60.0)
    snap = T.TRACER.snapshot()
    assert all(snap.by_i[g.parent].name == "serve.step.enqueue"
               for g in snap.named("model.decode.graph"))


@pytest.mark.parametrize("program", ["no tracer", "empty", "no graph"])
def test_graph_share_finds_nothing_without_the_span(program, tracer,
                                                    monkeypatch):
    tr, c = tracer
    if program != "empty":
        decode_tick(tr, c, 2 * S_NS, 0, enqueue=MS)
    if program == "no tracer":
        monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read("decode_graph_share", context()) is None
