"""Share of the window's decode steps whose model call replayed a
captured CUDA graph, in %: of the ``serve.step.enqueue`` spans in the
window, those that hold a ``model.decode.graph`` span of mode ``replay``
(``repro_torch/models/decode_graph.py``).  Spans of the program's own
tracer (``repro_torch/trace.py``); the window whole, since how a step ran
does not depend on the profiler.  None for a program without the span."""


def read(ctx):
    try:
        from repro_torch.trace import TRACER
    except ImportError:             # a program without the tracer
        return None
    snap = TRACER.snapshot()
    a, b = int(ctx.rec.t_open * 1e9), int(ctx.rec.t_close * 1e9)
    graphs = snap.between("model.decode.graph", a, b)
    steps = snap.between("serve.step.enqueue", a, b)
    if not graphs or not steps:
        return None
    replayed = {s.parent for s in graphs if s.attrs[0] == "replay"}
    return 100.0 * sum(s.i in replayed for s in steps) / len(steps)
