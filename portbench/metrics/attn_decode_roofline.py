"""Kernels (``csrc/``, decode): the least time the decode blocks' attention
needs, from each block's composition priced by the family's ``costs``
(bytes: the cached tokens every step of every row reads, once a row),
over the device time of the decode attention kernels (split, merge and
combine passes included) the blocks launched."""

from portbench.costs import bound_s

KERNELS = r"decode|combine"


def read(ctx):
    blocks = [o for o in ctx.occurrences("engine.decode_block") if o.ops and o.comps]
    spent = sum(o.matching_s(KERNELS) for o in blocks)
    need = sum(bound_s(ctx.costs.attn_flops(ctx.hf, c["attn_q_ctx"]),
                       ctx.costs.attn_bytes(ctx.hf, c["q_tokens"], c["kv_read_tokens"]))
               for c in ctx.comps_of(blocks))
    return need / spent * 100.0 if spent and need else None
