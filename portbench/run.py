"""One run of one cell of the port's benchmark:

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from process start): the port's engine is built for
the cell's configuration, the benchmark's seeded weights are written into
its parameters by name, ``Engine.warmup()`` captures its step graphs, the
traffic's set-up runs (the prefixes prefilled through the split lane
where the mix asks for it, then round 0 of every client through the
scheduler). The window drives ``Scheduler.submit`` in-process, closed loop,
and times every token at ``Request.on_token`` on the benchmark's clock;
after it no request is sent and each one in flight is followed to its
end. With ``--trace 1`` a ``torch.profiler`` capture of the serving loop
covers a sub-window, and the per-layer metrics are read from it and from
the port's counters. Then ``memory_peak_bytes`` is read, the port is
freed, and ``judge`` decides ``correct`` against the plain reference.

The last line of standard output is the result; the last lines of
standard error name each compared number with its limit."""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level module names that no run may load (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "opsagent_tpu")
# Seconds after the window for the requests in flight to finish.
DRAIN_S = 90.0
# Traced sub-window: at most this long, centred in the window. The port's
# capture host stops a capture within 30 s, and stopping parses every event
# on the serving thread: at 6 s, DeepSeek-V2-Lite's ~1,000 kernels a decode
# step took longer than that.
TRACE_S = 3.0


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - process_age_s()


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, set
    before the port is imported (it reads them at import)."""
    os.environ["OPSAGENT_KERNEL_DIR"] = str(root / "build" / "opsagent_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "portbench" / "triton")
    os.environ["OPSAGENT_FLIGHT_DIR"] = str(root / "build" / "portbench" / "flight")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Record:
    rq: object              # the generator's request
    submit: float = 0.0
    times: list[float] = field(default_factory=list)
    req: object = None


def percentile(values: list[float], q: int) -> float:
    """The q-th percentile (linear between order statistics)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False) -> dict:
    """One run; returns {"result": the result line's object, "compared":
    {name: (value, limit)}, "control": the control's gaps or None, "info"}.
    ``correct`` compares each number the cell's ``limits`` name: the mean
    and the widest gap of the served tokens (``judge``)."""
    import torch

    from opsagent_tpu_torch import obs
    from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
    from opsagent_tpu_torch.serving.sampler import SamplingParams
    from opsagent_tpu_torch.serving.scheduler import Request, Scheduler
    from opsagent_tpu_torch.utils import profiling

    from . import judge
    from .adapters import port_config
    from .generator import Traffic
    from .weights import Maker

    conf, mix = cell.config, cell.mix
    dtype = getattr(torch, conf["dtype"])
    reference, costs, adapter = (cell.family(k) for k in ("reference", "costs", "adapters"))
    port_cfg = port_config(conf)
    adapter.check(conf, port_cfg)
    engine_kw = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["engine"].items()}
    ecfg = EngineConfig(model=conf["preset"], dtype=dtype, device=device,
                        seed=seed % (1 << 62), **engine_kw)
    # Set-up's steps, in seconds from process start.
    marks: dict[str, float] = {}

    def mark(name: str) -> None:
        marks[name] = time.perf_counter() - T_START

    mark("imported")
    engine = Engine(ecfg, model_cfg=port_cfg)
    dev = engine.device
    mark("engine")
    adapter.load(engine.model, conf, Maker(seed, dev, dtype))
    mark("weights")

    # The compositions the engine hands its attribution hook, each marked on
    # the profiler's timeline of the calling (scheduler) thread.
    comps: list[dict] = []
    priced = engine.attr.dispatch

    def hooked(op: str, **kw):
        comps.append(dict(op=op, **kw))
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(f"portbench.attr.{len(comps) - 1}"):
                pass
        return priced(op, **kw)

    engine.attr.dispatch = hooked
    engine.warmup()
    mark("warmup")
    traffic = Traffic(mix, seed, tuple(conf["token_range"]))
    if mix.get("prefix_setup") == "split_lane":
        for seq in traffic.warm():
            sid = engine.begin_request(seq, SamplingParams(max_tokens=1))
            while not engine.prefill_batch([sid])[sid]:
                pass
            engine.finish(sid)
    mark("prefixes")
    sched = Scheduler(engine)
    sched.start()
    clock = time.perf_counter

    def submit(rq) -> Record:
        rec = Record(rq)
        rec.req = Request(list(rq.prompt), SamplingParams(max_tokens=rq.max_tokens),
                          on_token=lambda _t, times=rec.times: times.append(clock()))
        rec.submit = clock()
        sched.submit(rec.req)
        return rec

    tmp = PKG.parent / "build" / "portbench" / "trace"
    if trace:
        # The process's first capture starts the profiler (seconds): in set-up.
        profiling.start_trace(str(tmp))
        os.remove(profiling.stop_trace())
    setup = [submit(traffic.request(c, 0)) for c in range(traffic.clients)]
    for rec in setup:
        rec.req.done.wait()
        if rec.req.error:
            raise RuntimeError(f"set-up request failed: {rec.req.error}")
        traffic.reply(rec.rq, rec.req.tokens)
    mark("round0")

    def counters() -> dict[str, float]:
        return {
            "queue_wait_sum": obs.QUEUE_WAIT_SECONDS.sum(),
            "queue_wait_count": obs.QUEUE_WAIT_SECONDS.count(),
            "prefix_hit": obs.PREFIX_HIT_TOKENS.value(),
            "prefill": obs.PREFILL_TOKENS.value(),
            "host_gap_sum": sum(obs.STEP_HOST_GAP_SECONDS.sum(mode=m) for m in ("sync", "async")),
            "host_gap_count": sum(obs.STEP_HOST_GAP_SECONDS.count(mode=m) for m in ("sync", "async")),
        }

    records: list[Record] = []
    current: dict[int, Record | None] = {c: None for c in range(traffic.clients)}
    rounds = {c: 1 for c in range(traffic.clients)}
    t0 = clock()
    setup_s = t0 - T_START
    window_counters = counters()
    t1 = t0 + seconds
    send_at = {c: t0 + traffic.think_s(c, 1) for c in current}
    traced: dict = {}
    tracer = None
    if trace:
        span = min(TRACE_S, seconds / 2)

        def trace_window() -> None:
            # The counters over the sub-window alone: stopping the capture
            # holds the serving loop while the profiler parses its events.
            time.sleep(max(0.0, t0 + (seconds - span) / 2 - clock()))
            profiling.start_trace(str(tmp))
            traced["c0"], start = counters(), clock()
            time.sleep(max(0.0, start + span - clock()))
            traced["c1"] = counters()
            traced["path"] = profiling.stop_trace()

        tracer = threading.Thread(target=trace_window, daemon=True)
        tracer.start()
    while True:
        now = clock()
        for c, rec in current.items():
            if rec is not None and rec.req.done.is_set():
                traffic.reply(rec.rq, rec.req.tokens)
                end = rec.times[-1] if rec.times else now
                rounds[c] += 1
                send_at[c] = end + traffic.think_s(c, rounds[c])
                current[c] = None
            if current[c] is None and now < t1 and now >= send_at[c]:
                current[c] = submit(traffic.request(c, rounds[c]))
                records.append(current[c])
        if now >= t1 and all(r is None for r in current.values()):
            break
        if now >= t1 + DRAIN_S:
            break
        time.sleep(0.0005)
    if tracer is not None:
        tracer.join()
    sched.stop()
    mark("drained")
    pages = engine.alloc.accounting()
    hits = {k: v - window_counters[k] for k, v in counters().items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # -- end-to-end metrics -------------------------------------------------
    deadline = t1 + DRAIN_S
    failed = [r for r in records if not r.req.done.is_set() or r.req.error]
    ok = [r for r in records if r not in failed]
    in_window = sum(1 for r in records for t in r.times if t0 <= t < t1)
    values = {
        "output_tok_s": in_window / seconds,
        "ttft_p90_ms": percentile(
            [((r.times[0] if r in ok and r.times else deadline) - r.submit) * 1e3
             for r in records], 90) if records else None,
        "tpot_p90_ms": percentile(
            [(r.times[-1] - r.times[0]) / (len(r.times) - 1) * 1e3
             for r in ok if len(r.times) >= 2], 90) if ok else None,
        "setup_s": setup_s,
    }
    metrics = {}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak),
    }
    breakdown = None
    if not trace:
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from .trace import summarize

        summary = summarize(traced["path"])
        os.remove(traced["path"])
        c0, c1 = traced["c0"], traced["c1"]
        ctx = Context(cell.config, costs, {k: c1[k] - c0[k] for k in c0}, summary, comps)
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = {"device_ops": summary.top_ops, "idle_gaps": summary.idle_gaps}

    # -- correct ------------------------------------------------------------
    done = [(r.rq.prompt, list(r.req.tokens)) for r in ok if r.req.tokens]
    del sched, engine, hooked, priced
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    mark("freed")
    picked = judge.sample(done, seed, cell.check.get("tokens", judge.CHECK_TOKENS))
    maker = Maker(seed, dev, dtype)
    gap, ctrl = judge.gaps(
        reference, conf, lambda sp: maker.make(sp).float(), done, picked, dev,
        control=judge.fp8_control(maker) if control else None,
    ) if picked else ({"mean": None, "max": None}, None)
    mark("checked")
    read = {"mean_logit_gap": gap["mean"], "max_logit_gap": gap["max"]}
    compared = {name: (read[name], float(lim)) for name, lim in cell.check["limits"].items()}
    compared["failed_requests"] = (len(failed), 0)
    result = {
        "correct": all(v is not None and v <= lim for v, lim in compared.values()),
        "attempted": len(records), "failed": len(failed),
        "metrics": metrics, "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    sampled = sum(len(done[j][1]) for g in picked for j in g)
    return {"result": result, "compared": compared, "control": ctrl,
            "info": {"checked_requests": sum(map(len, picked)), "checked_reads": len(picked),
                     "checked_tokens": sampled, "logit_gap": gap,
                     "values": values, "held_after_free_bytes": held,
                     "kv_pages_held": pages["total"] - pages["free"], "kv_pages": pages["total"],
                     "prefix_hit_tokens": hits["prefix_hit"], "prefill_tokens": hits["prefill"],
                     "marks_s": {k: round(v, 3) for k, v in marks.items()}}}


@dataclass
class Context:
    """What a per-layer reader reads: the configuration's published sizes,
    the family's cost arithmetic, the port's counters' changes over the
    window, the trace's summary and the compositions it marks."""

    hf: dict
    costs: object
    counters: dict[str, float]
    trace: object
    comps: list[dict]

    def occurrences(self, *names: str) -> list:
        return [o for o in self.trace.occurrences if o.name in names]

    def comps_of(self, occs: list) -> list[dict]:
        return [self.comps[i] for o in occs for i in o.comps]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    import torch

    from . import spec

    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"info": out["info"]}), file=sys.stderr)
    for name, (value, limit) in out["compared"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0
