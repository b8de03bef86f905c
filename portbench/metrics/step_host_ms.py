"""Mean host time of a decode step outside the model's enqueue and the
wait for its result, in ms: each ``serve.step`` span less its
``serve.step.enqueue`` and ``serve.step.sync`` children, so the block
tables' growth and push, the loop over the slots and the step's own
Python.  Spans of the program's own tracer (``repro_torch/trace.py``) in
the window before tracing."""

NOT_HOST = ("serve.step.enqueue", "serve.step.sync")


def read(ctx):
    try:
        from repro_torch.trace import TRACER
    except ImportError:             # a program without the tracer
        return None
    snap = TRACER.snapshot()
    steps = snap.between("serve.step", int(ctx.rec.t_open * 1e9),
                         ctx.traced_from_ns)
    if not steps:
        return None
    host = [s.ns - sum(c.ns for c in snap.children(s) if c.name in NOT_HOST)
            for s in steps]
    return sum(host) / len(host) / 1e6
