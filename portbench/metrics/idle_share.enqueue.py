"""Share of the traced part of the window in which the device was idle
while the host was enqueueing work, in %: each idle gap of the device
trace whose start lies inside a ``serve.step.enqueue`` or
``serve.prefill.enqueue`` span (the launches of a decode step or a
prefill).  With ``idle_share.engine``, it sums to ``idle_share``.

Each tick's spans (``repro_torch/trace.py``) go onto the trace's clock
by their own ``serve.tick``'s pair of host clocks, then by the drift of
the device's clock from the host's, which that pair cannot see: on an
H100 the profiler's device times left the host's from about 0.4 s into
a trace, at -1% to +1.6% (-26 to +42 ms over 3 s).  Every sync span
(``serve.step.sync``, ``serve.prefill.sync``) ends once its argmax's copy
to the host has ended, 10-140 us later, so :func:`anchors` follows those
copies from one sync to the next, and each tick's spans move so that its
last sync ends where its copy ended."""
import bisect

ENQUEUE = ("serve.step.enqueue", "serve.prefill.enqueue")
SYNC = ("serve.step.sync", "serve.prefill.sync")
FIRST_NS = 2_000_000    # how far before the first sync its copy may end
STEP_NS = 300_000       # how far a copy may lie from where the drift so far
RATE = 0.02             # puts it, plus RATE of the time since the last one
#   (1.6% was seen, 0.45 ms a decode tick; the next step's first copy
#   comes 1.1 ms or more after a step's argmax copy)


def anchors(snap, trace):
    """[(sync end by the host's clocks, its tick's index, ns its copy
    ended after that)] for every sync in the traced part whose copy was
    found, oldest first."""
    ends = sorted(b for name, a, b in trace.ops if "Memcpy DtoH" in name)
    syncs = []
    for name in SYNC:
        for s in snap.named(name):
            tick = snap.root(s)
            if tick is not None:
                e = s.t1 + tick.attrs[0] - tick.t0
                if trace.t0 <= e <= trace.t1:
                    syncs.append((e, tick.i))
    out, rate = [], 0.0
    for e, tick in sorted(syncs):
        if not out:
            want, lo, hi = e, e - FIRST_NS, e + STEP_NS
        else:
            last, _, c = out[-1]
            want = e + c + int(rate * (e - last))
            w = STEP_NS + int(RATE * (e - last))
            lo, hi = want - w, want + w
        near = ends[bisect.bisect_left(ends, lo):bisect.bisect_right(ends, hi)]
        if near:
            c = min(near, key=lambda x: abs(x - want)) - e
            if out and e > out[-1][0]:
                rate = (rate + (c - out[-1][2]) / (e - out[-1][0])) / 2
            out.append((e, tick, c))
    return out


def drift(snap, trace):
    """{``serve.tick`` index: ns to add to its spans on the trace's clock}
    for every tick that ends in the traced part, each from its last sync's
    copy, or the one before it where a tick has none."""
    moved = {tick: c for _, tick, c in anchors(snap, trace)}
    out, c = {}, None
    for t in snap.named("serve.tick"):
        c = moved.get(t.i, c)
        if c is not None and trace.t0 <= t.attrs[0] + t.ns <= trace.t1:
            out[t.i] = c
    return out


def read(ctx):
    try:
        from repro_torch.trace import TRACER
    except ImportError:             # a program without the tracer
        return None
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    snap = TRACER.snapshot()
    shift = drift(snap, tr)
    if not shift:
        return None
    gaps = tr.gaps()
    inside = snap.inside(ENQUEUE, [a for a, _ in gaps], shift)
    idle = sum(b - a for (a, b), x in zip(gaps, inside) if x)
    return 100.0 * idle / (tr.t1 - tr.t0)
