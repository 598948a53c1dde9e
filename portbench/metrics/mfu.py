"""The whole step: the useful model operations of every dispatch marked in
the traced sub-window (two per active body parameter a token, and the
attention over valid pairs, by the family's ``costs``) over the
sub-window's seconds at the bf16 peak."""

from portbench.costs import PEAK_BF16_FLOPS


def read(ctx):
    comps = ctx.comps_of(ctx.trace.occurrences)
    flops = sum(ctx.costs.model_flops(ctx.hf, c["q_tokens"], c["attn_q_ctx"]) for c in comps)
    return flops / (ctx.trace.window_s * PEAK_BF16_FLOPS) * 100.0 if flops else None
