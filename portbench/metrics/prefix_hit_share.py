"""Prefix cache (``serving/kvcache.py``, the engine's admission): the share
of prompt tokens served from cached pages over the window,
Δ``opsagent_prefix_hit_tokens_total`` / (Δhit + Δ``opsagent_prefill_tokens_total``)."""


def read(ctx):
    hit, miss = ctx.counters["prefix_hit"], ctx.counters["prefill"]
    return hit / (hit + miss) * 100.0 if hit + miss else None
