"""Share of the window's glue sites that ran the fused kernels, in %: of
the ``model.glue`` spans in the window, one a paged prefill call and one
a paged decode step, attrs ``(fused, torch)``, the sites of the model's
layer glue (residual add + RMSNorm, RoPE and the pool write, SwiGLU) on
each path (``repro_torch/models/glue.py``; a replayed step counts its
capture's), 100 x the fused sites over all of them.  Spans of the
program's own tracer (``repro_torch/trace.py``); the window whole, since
which path a site took does not depend on the profiler.  None for a
program without the span."""


def read(ctx):
    try:
        from repro_torch.trace import TRACER
    except ImportError:             # a program without the tracer
        return None
    snap = TRACER.snapshot()
    a, b = int(ctx.rec.t_open * 1e9), int(ctx.rec.t_close * 1e9)
    spans = snap.between("model.glue", a, b)
    fused = sum(s.attrs[0] for s in spans)
    total = fused + sum(s.attrs[1] for s in spans)
    return 100.0 * fused / total if total else None
