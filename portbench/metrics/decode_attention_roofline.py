"""The paged decode-attention kernel's least time over its device time, in
% (``portbench/roofline/decode_attention.py``), over the decode steps of
the traced part of the window: each ``engine.step`` span's kernels of
that name, and one call a layer at the rows' lengths plus one."""
from portbench.roofline import decode_attention as K
from portbench.roofline import peaks


def read(ctx):
    steps = ctx.traced("engine.step")
    if not steps:
        return None
    c = ctx.cfg
    hd = c.get("head_dim") or c["d_model"] // c["n_heads"]
    least = device = 0.0
    for s, ops in zip(sorted(steps, key=lambda s: s.t0), ctx.ops_in(steps)):
        mine = [o for o in ops if K.KERNEL in o[0]]
        if not mine:
            continue
        kv = ctx.host_lens(s.meta) + 1
        fl, nb = K.flops_bytes(len(kv), c["n_heads"], c["n_kv_heads"], hd,
                               kv, block_size=ctx.block_size)
        least += c["n_layers"] * peaks.least_s(fl, nb)
        device += sum(b - a for _, a, b in mine) / 1e9
    return 100.0 * least / device if device else None
