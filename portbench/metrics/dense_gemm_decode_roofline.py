"""The dense decode step's matrix products, their least time over their
device time, in % (``portbench/roofline/dense_gemm.py``): the cuBLAS
kernels inside the traced ``engine.step`` spans, seven products a layer
and the unembedding at the step's rows.  None for a routed model, whose
feed-forward runs on the gmm kernel."""
from portbench.roofline import dense_gemm as K
from portbench.roofline import peaks


def read(ctx):
    steps = ctx.traced("engine.step")
    if not steps or ctx.cfg["family"] != "dense":
        return None
    least = device = 0.0
    for s, ops in zip(sorted(steps, key=lambda s: s.t0), ctx.ops_in(steps)):
        mine = [o for o in ops if K.is_gemm(o[0])]
        if not mine:
            continue
        least += K.step_least_s(ctx.cfg, len(ctx.host_lens(s.meta)),
                                peaks.least_s)
        device += sum(b - a for _, a, b in mine) / 1e9
    return 100.0 * least / device if device else None
