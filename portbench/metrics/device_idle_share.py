"""Device: the share of the traced sub-window in which no operation ran."""


def read(ctx):
    w = ctx.trace.window_s
    return (1.0 - ctx.trace.busy_s / w) * 100.0 if w > 0 else None
