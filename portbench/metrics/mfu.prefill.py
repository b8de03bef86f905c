"""The prefills' least time at the card's bf16 peak over their wall, in %.

Each ``serve.prefill`` span of the program's own tracer (``repro_torch/
trace.py``; one a bucket, its ``.enqueue``, ``.splice`` and ``.sync``
inside) in the window before tracing: the model operations of its
prompts, each at its own length (``portbench/roofline/step.py:
prefill_flops``; the rids the span keeps name the prompts), over 989.4
TFLOP/s, against the spans' summed wall.  Low where an admit is bound by
its launches or by reading every weight for a bucket of few tokens, high
where by compute."""
from portbench.roofline import peaks, step


def read(ctx):
    try:
        from repro_torch.trace import TRACER
    except ImportError:             # a program without the tracer
        return None
    spans = TRACER.snapshot().between(
        "serve.prefill", int(ctx.rec.t_open * 1e9), ctx.traced_from_ns)
    flops = wall = 0
    for s in spans:
        rids = s.attrs[3]
        if not all(r in ctx.rec.sent for r in rids):
            continue
        flops += step.prefill_flops(ctx.cfg, [ctx.rec.sent[r].prompt_len
                                              for r in rids])
        wall += s.ns
    if not wall:
        return None
    return 100.0 * flops / peaks.PEAK_FLOPS["bfloat16"] / (wall / 1e9)
