"""Mean host time of the bundle's ``decode_paged`` call, which returns
before the device has finished the step: the cost of launching it, which
a captured graph would take away.  ``model.decode`` spans of the window
before tracing."""


def read(ctx):
    walls = [s.ms for s in ctx.host("model.decode")]
    return sum(walls) / len(walls) if walls else None
