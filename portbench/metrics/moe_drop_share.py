"""Share of the (token, expert) pairs that the MoE blocks of decode steps
dropped at capacity, in %: over every MoE call made inside a
``serve.step.enqueue`` span in the window, the pairs past each expert's
capacity, sum(max(count - capacity, 0)), over the pairs routed (every row
the step routes, live or not).  The per-expert counts the program's
tracer keeps (``repro_torch/trace.py``), copied to the host once, after
the window; the window whole, since a count does not depend on the
profiler."""
import numpy as np


def read(ctx):
    try:
        from repro_torch.trace import TRACER, moe_counts
    except ImportError:             # a program without the tracer
        return None
    snap = TRACER.snapshot()
    steps = {s.i for s in snap.between("serve.step.enqueue",
                                       int(ctx.rec.t_open * 1e9),
                                       int(ctx.rec.t_close * 1e9))}
    entries = [m for m in snap.moe if m[3] in steps]
    if not entries:
        return None
    counts, caps, _ = moe_counts(entries)
    dropped = np.clip(counts - caps[:, None], 0, None).sum()
    return 100.0 * float(dropped) / float(counts.sum())
