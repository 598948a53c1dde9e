"""Engine host path (``serving/engine.py``, ``async_runtime.py``): mean of
``opsagent_step_host_gap_seconds`` (enqueue return to the next mixed tick's
enqueue) over the window."""


def read(ctx):
    n = ctx.counters["host_gap_count"]
    return ctx.counters["host_gap_sum"] / n * 1e3 if n else None
