"""Mean wall of the engine ticks that ran a prefill (admitted a request),
from the ``engine.tick`` spans of the window before tracing."""


def read(ctx):
    walls = [s.ms for s in ctx.host("engine.tick") if s.meta]
    return sum(walls) / len(walls) if walls else None
