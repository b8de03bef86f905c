"""Mean wall of the engine ticks that admitted nothing (one decode step
each), from the ``engine.tick`` spans of the window before tracing (a span
keeps what the tick returned: its ``admitted`` count)."""


def read(ctx):
    walls = [s.ms for s in ctx.host("engine.tick") if s.meta == 0]
    return sum(walls) / len(walls) if walls else None
