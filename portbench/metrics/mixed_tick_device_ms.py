"""Model step under ``engine.mixed_step`` / ``engine.mixed_step_async``: the
device time of what each mixed tick launched, per tick, over the traced
sub-window."""

MIXED = ("engine.mixed_step", "engine.mixed_step_async")


def read(ctx):
    ticks = [o for o in ctx.occurrences(*MIXED) if o.ops]
    return sum(o.device_s for o in ticks) / len(ticks) * 1e3 if ticks else None
