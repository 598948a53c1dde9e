"""Model step under ``engine.decode_block``: the device time of what the
blocks launched, per decode step (a block's steps are the ``weight_streams``
of its composition), over the traced sub-window."""


def read(ctx):
    blocks = [o for o in ctx.occurrences("engine.decode_block") if o.ops and o.comps]
    steps = sum(c["weight_streams"] for c in ctx.comps_of(blocks))
    return sum(o.device_s for o in blocks) / steps * 1e3 if steps else None
