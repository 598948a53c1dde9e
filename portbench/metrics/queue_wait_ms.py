"""Scheduler (``serving/scheduler.py``): mean admission wait over the
window, from the deltas of ``opsagent_queue_wait_seconds``' sum and count."""


def read(ctx):
    n = ctx.counters["queue_wait_count"]
    return ctx.counters["queue_wait_sum"] / n * 1e3 if n else None
