"""Share of the traced part of the window in which no operation ran on the
device, in %: 1 - busy / window from the device trace."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
