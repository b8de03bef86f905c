"""Mean wait of the host for a decode step's result, in ms: the
``serve.step.sync`` span from the argmax's launch, after the step's last
kernel, until its copy is on the host.  With the profiler off, the part of
a step in which the host waits on the device.  Spans of the program's own
tracer (``repro_torch/trace.py``) in the window before tracing."""


def read(ctx):
    try:
        from repro_torch.trace import TRACER
    except ImportError:             # a program without the tracer
        return None
    syncs = TRACER.snapshot().between(
        "serve.step.sync", int(ctx.rec.t_open * 1e9), ctx.traced_from_ns)
    return sum(s.ns for s in syncs) / len(syncs) / 1e6 if syncs else None
