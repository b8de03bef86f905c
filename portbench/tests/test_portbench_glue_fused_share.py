"""The reader of the glue span (``glue_fused_share``), on a made-up
tracer: the ``model.glue`` span, attrs ``(fused, torch)``, that the LM
bundle's ``prefill_paged`` records under ``serve.prefill.enqueue`` and its
``decode_paged`` under ``serve.step.enqueue``."""
from __future__ import annotations

import sys

import pytest

from portbench.tests.test_portbench_program_readers import (
    MS, S_NS, decode_tick, context, read, tracer)  # noqa: F401 (fixture)
from repro_torch import trace as T


def glue_tick(tr, c, t0, sites, prefill=False):
    """One tick from perf time ``t0`` whose 1 ms enqueue (a decode step's,
    or a prefill's) records a ``model.glue`` span of ``sites`` (fused,
    torch), none where ``sites`` is None."""
    c.t = t0
    tr.open_tick(1)
    part = "serve.prefill" if prefill else "serve.step"
    tr.open(part, 1)
    tr.open(part + ".enqueue", 1)
    c.t += MS
    if sites is not None:
        tr.record("model.glue", c.t - MS, sites)
    tr.lap(part + ".sync")
    c.t += MS
    tr.close()
    tr.close((4,))
    tr.close_tick((0, 4, 0, 4))


def test_glue_share_counts_the_window_sites_on_each_path(tracer):
    tr, c = tracer
    # before the window, all on torch's ops; in it a prefill and three
    # steps (a replay counts its capture's sites, as the runner records
    # them), one step without the span; after it, torch's ops again
    glue_tick(tr, c, S_NS // 2, (0, 85))
    glue_tick(tr, c, 2 * S_NS, (85, 0), prefill=True)
    for k, sites in enumerate(((85, 0), (80, 5), None, (85, 0))):
        glue_tick(tr, c, (3 + k) * S_NS, sites)
    glue_tick(tr, c, 21 * S_NS, (0, 85))
    assert read("glue_fused_share", context()) == pytest.approx(
        100.0 * (85 + 85 + 80 + 85) / (4 * 85))
    snap = T.TRACER.snapshot()
    assert {snap.by_i[g.parent].name for g in snap.named("model.glue")} \
        == {"serve.step.enqueue", "serve.prefill.enqueue"}


@pytest.mark.parametrize("sites, share", [((85, 0), 100.0),
                                          ((0, 85), 0.0)])
def test_glue_share_reads_one_path_whole(sites, share, tracer):
    tr, c = tracer
    for k in range(3):
        glue_tick(tr, c, (2 + k) * S_NS, sites, prefill=k == 0)
    assert read("glue_fused_share", context()) == pytest.approx(share)


@pytest.mark.parametrize("program", ["no tracer", "empty", "no glue span",
                                     "no sites"])
def test_glue_share_finds_nothing_without_the_span(program, tracer,
                                                   monkeypatch):
    tr, c = tracer
    if program == "no glue span":
        decode_tick(tr, c, 2 * S_NS, 0, enqueue=MS)
    elif program in ("no tracer", "no sites"):
        glue_tick(tr, c, 2 * S_NS, (0, 0))
    if program == "no tracer":
        monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read("glue_fused_share", context()) is None
