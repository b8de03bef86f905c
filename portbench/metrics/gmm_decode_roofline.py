"""The grouped matmul's least time over its device time at decode, in %
(``portbench/roofline/gmm.py``): the gmm kernels inside the traced
``engine.step`` spans, three launches a layer at the capacity of the
step's rows."""
from portbench.roofline import gmm as K
from portbench.roofline import peaks


def read(ctx):
    steps = ctx.traced("engine.step")
    if not steps or ctx.cfg["family"] != "moe":
        return None
    least = device = 0.0
    for s, ops in zip(sorted(steps, key=lambda s: s.t0), ctx.ops_in(steps)):
        mine = [o for o in ops if K.KERNEL in o[0]]
        if not mine:
            continue
        least += ctx.cfg["n_layers"] * K.layer_least_s(
            ctx.cfg, len(ctx.host_lens(s.meta)), peaks.least_s)
        device += sum(b - a for _, a, b in mine) / 1e9
    return 100.0 * least / device if device else None
