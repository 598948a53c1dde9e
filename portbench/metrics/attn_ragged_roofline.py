"""Kernels (``csrc/``, ragged): the least time the mixed ticks' attention
needs, from each tick's composition (valid tokens only: its query tokens,
the cached tokens its rows read, its (query, position) pairs) priced by
the family's ``costs``, over the device time of the ragged attention
kernels (merge and combine passes included) the ticks launched. The
composition counts a page that several rows read once per row."""

from portbench.costs import bound_s

MIXED = ("engine.mixed_step", "engine.mixed_step_async")
KERNELS = r"ragged|combine"


def read(ctx):
    ticks = [o for o in ctx.occurrences(*MIXED) if o.ops and o.comps]
    spent = sum(o.matching_s(KERNELS) for o in ticks)
    need = sum(bound_s(ctx.costs.attn_flops(ctx.hf, c["attn_q_ctx"]),
                       ctx.costs.attn_bytes(ctx.hf, c["q_tokens"], c["kv_read_tokens"]))
               for c in ctx.comps_of(ticks))
    return need / spent * 100.0 if spent and need else None
