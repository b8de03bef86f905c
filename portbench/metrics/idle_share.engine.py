"""Share of the traced part of the window in which the device was idle
while the host was not enqueueing work, in %: ``idle_share`` less
``idle_share.enqueue``, so the idle gaps that start in the engine's own
work (admission, the block tables, the splices, the waits for results,
the loop over the slots) or outside any ``serve.tick``."""
from portbench.harness import spec as S


def read(ctx):
    enqueue = S.metric_reader("idle_share.enqueue").read(ctx)
    if enqueue is None:
        return None
    return S.metric_reader("idle_share").read(ctx) - enqueue
