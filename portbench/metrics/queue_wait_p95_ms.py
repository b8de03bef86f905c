"""95th percentile of a request's wait in the engine's queue, in ms: from
its ``request.submit`` to its ``request.admit`` (the start of its prefill
bucket), over the requests admitted in the window before tracing.  Events
of the program's own tracer (``repro_torch/trace.py``)."""
import numpy as np


def read(ctx):
    try:
        from repro_torch.trace import TRACER
    except ImportError:             # a program without the tracer
        return None
    snap = TRACER.snapshot()
    submit = {(e.engine, e.rid): e.t for e in snap.named("request.submit")}
    waits = [e.t - submit[e.engine, e.rid]
             for e in snap.between("request.admit", int(ctx.rec.t_open * 1e9),
                                   ctx.traced_from_ns)
             if (e.engine, e.rid) in submit]
    return float(np.percentile(waits, 95)) / 1e6 if waits else None
