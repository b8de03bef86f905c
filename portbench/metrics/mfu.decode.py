"""The decode steps' least time at the card's peaks over their wall, in %.

Each ``engine.step`` span (the block-table growth, the model's step and
the argmax on the host) of the window before tracing, with the lengths
its rows had: the least time is the larger of the step's operations over
989.4 TFLOP/s and its bytes over 3.35 TB/s (``portbench/roofline/
step.py``: every weight once, experts as far as reached, the K/V cache
at the rows' live lengths)."""
from portbench.roofline import peaks, step


def read(ctx):
    spans = ctx.host("engine.step")
    if not spans:
        return None
    least = 0.0
    for s in spans:
        kv = ctx.host_lens(s.meta) + 1
        least += peaks.least_s(*step.decode_flops_bytes(ctx.cfg, kv))
    return 100.0 * least / (sum(s.ms for s in spans) / 1e3)
