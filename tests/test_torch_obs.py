"""The port's observability (``opsagent_tpu_torch.obs``, its ``utils.logger``,
``utils.perf`` and ``utils.profiling``) against the JAX package's
``opsagent_tpu.obs`` on the CPU, fed the same inputs made from a seed with
numpy.

- ``Registry.render()`` is byte-equal after the same operations, label
  values that need escaping included; only the HELP lines of the compile
  family (a CUDA-graph capture or an nvcc build in the port, an XLA compile
  in JAX) and of the two attribution peaks (the H100's in the port) differ.
  Both documents pass the exposition grammar of
  ``tests/test_metrics_conformance.py``, and both declare the same families.
- ``Trace.to_dict`` and ``format_tree``, tail retention at p = 0 and p = 1,
  ``timeline.assemble``/``render_gantt`` and ``stitch_fleet``/
  ``render_fleet_gantt`` are equal given the same injected clocks.
- ``slo.evaluate`` and ``histogram_quantile`` are equal on the same samples;
  ``history.query``/``rate``/``window_sum`` with an injected ``now``.
- ``Attribution.cost``, ``dispatch`` and ``snapshot`` are equal for the same
  config, quantization and weight stream with the peaks set explicitly;
  ``for_engine`` over the port's and JAX's configs gives the same
  coefficients; the port's defaults are the H100's.
- The compile watchdog: a real ``StepGraph`` over a stand-in of the CUDA
  graph API and a cached or uncached kernel build (a stand-in nvcc) give
  the startup, warmup and serving phases and the anomaly, as JAX's listener
  does for an XLA compile.
- ``ModelConfig.num_params`` equals JAX's for every preset and the dense HF
  fixtures; ``timed_capture(0.2)`` writes a CPU trace.
"""

import json
import math
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

from opsagent_tpu import obs as jobs
from opsagent_tpu.models import config as jconfig
from opsagent_tpu.utils.perf import get_perf_stats as jax_perf
from opsagent_tpu_torch import obs as pobs
from opsagent_tpu_torch.models import config as pconfig
from opsagent_tpu_torch.utils import profiling
from opsagent_tpu_torch.utils.perf import get_perf_stats as port_perf

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
DENSE_FIXTURES = ("tiny-llama-hf", "tiny-qwen2-hf", "tiny-qwen3-hf")
PRESETS = ("tiny-test", "bench-1b", "bench-8b", "qwen2.5-7b-instruct")
# The families whose HELP text says what the port counts: the compile
# family and the attribution peaks (the H100's, not the v5e's).
HELP_DIFFERS = frozenset({
    "opsagent_xla_compiles_total", "opsagent_xla_compile_seconds",
    "opsagent_post_warmup_compiles", "opsagent_compile_cache_events_total",
    "opsagent_attr_mfu", "opsagent_attr_hbm_utilization",
})


def reset_port_obs():
    """The port's counterpart of tests/conftest.py's JAX obs reset: its
    registry, trace store, flight ring, compile watchdog, SLO watchdog,
    history and retention are process-wide too."""
    pobs.get_registry().reset()
    pobs.get_store().clear()
    pobs.flight.get_recorder().reset()
    pobs.flight.reset_compile_watchdog()
    pobs.slo.get_watchdog().reset()
    pobs.history.reset()
    pobs.trace.reset_retention()
    port_perf().reset()


@pytest.fixture(autouse=True)
def clean_port_obs(tmp_path, monkeypatch):
    # Anomaly dumps of both packages land in the test's directory.
    monkeypatch.setenv("OPSAGENT_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_port_obs()
    yield
    reset_port_obs()


# -- the exposition grammar (tests/test_metrics_conformance.py's rules) ------
METRIC_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
LABEL_NAME = r"[a-zA-Z_][a-zA-Z0-9_]*"
LABEL_VALUE = r'"(?:[^"\\\n]|\\\\|\\"|\\n)*"'
LABELS = rf"\{{{LABEL_NAME}={LABEL_VALUE}(?:,{LABEL_NAME}={LABEL_VALUE})*,?\}}"
VALUE = r"(?:[+-]?(?:\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|Inf)|NaN)"
SAMPLE_RE = re.compile(rf"^({METRIC_NAME})({LABELS})? ({VALUE})(?: [+-]?\d+)?$")
HELP_RE = re.compile(rf"^# HELP ({METRIC_NAME}) .*$")
TYPE_RE = re.compile(rf"^# TYPE ({METRIC_NAME}) (counter|gauge|histogram|summary|untyped)$")
HISTO_SUFFIX = re.compile(r"_(bucket|sum|count)$")


def conform(text: str) -> dict[str, str]:
    """Assert ``text`` is a valid exposition document; returns its
    family -> TYPE map."""
    assert text.endswith("\n")
    types: dict[str, str] = {}
    samples: dict[tuple, float] = {}
    order: list[str] = []
    for ln in text.split("\n")[:-1]:
        if ln.startswith("# HELP "):
            assert HELP_RE.match(ln), ln
            continue
        if ln.startswith("# TYPE "):
            m = TYPE_RE.match(ln)
            assert m and m.group(1) not in types, ln
            types[m.group(1)] = m.group(2)
            continue
        m = SAMPLE_RE.match(ln)
        assert m, f"bad sample line: {ln!r}"
        name = m.group(1)
        h = HISTO_SUFFIX.search(name)
        fam = name[:h.start()] if h and types.get(name[:h.start()]) == "histogram" else name
        order.append(fam)
        key = (name, m.group(2) or "")
        assert key not in samples, ln
        samples[key] = float(m.group(3).replace("Inf", "inf"))
    done, prev = set(), None
    for fam in order:
        if fam != prev:
            assert fam not in done, f"{fam} interleaved"
            if prev is not None:
                done.add(prev)
            prev = fam
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        by_child: dict[str, list] = {}
        for (name, labels), v in samples.items():
            if name != f"{fam}_bucket":
                continue
            le = re.search(rf'le="({VALUE})"', labels).group(1)
            rest = re.sub(rf',?le="{re.escape(le)}"', "", labels)
            by_child.setdefault("" if rest == "{}" else rest, []).append(
                (float(le.replace("Inf", "inf")), v))
        for child, series in by_child.items():
            series.sort()
            counts = [c for _, c in series]
            assert series[-1][0] == math.inf and counts == sorted(counts)
            assert samples[(f"{fam}_count", child)] == counts[-1]
            assert (f"{fam}_sum", child) in samples
    return types


# -- the same traffic into both packages --------------------------------------
LABEL_POOL = ("plain", 'quo"te', "back\\slash", "new\nline", "/v1/chat/completions")
COUNTERS = (("DECODE_TOKENS", ()), ("PREFILL_TOKENS", ()), ("PREFIX_HIT_TOKENS", ()),
            ("ENGINE_REQUESTS", ("outcome",)), ("HTTP_REQUESTS", ("method", "path", "status")),
            ("TOOL_CALLS", ("tool", "outcome")), ("DECODE_DISPATCHES", ("kind",)),
            ("ANOMALIES", ("reason",)), ("CLASS_REQUESTS", ("class", "outcome")),
            ("COMPILES", ("phase",)), ("FLEET_SHED", ("class",)))
GAUGES = (("KV_PAGE_UTILIZATION", ()), ("KV_PAGES_FREE", ()), ("BATCH_OCCUPANCY", ()),
          ("FLEET_REPLICAS", ("role", "state")), ("SNAPSHOT_BYTES", ("part",)),
          ("POST_WARMUP_COMPILES", ()))
HISTOGRAMS = (("TTFT_SECONDS", ()), ("ITL_SECONDS", ()), ("QUEUE_WAIT_SECONDS", ()),
              ("HTTP_LATENCY_SECONDS", ("path",)), ("CLASS_TTFT_SECONDS", ("class",)),
              ("COMPILE_SECONDS", ("phase",)), ("MIXED_DECODE_LANES", ()))


def traffic(seed: int, n: int = 60) -> list[tuple]:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = str(rng.choice(["counter", "gauge", "histogram", "perf"]))
        table = {"counter": COUNTERS, "gauge": GAUGES, "histogram": HISTOGRAMS}.get(kind)
        if table is None:
            ops.append(("perf", str(rng.choice(["engine.ttft", 'se"ries', "x.y"])),
                        round(float(rng.uniform(0, 50)), 4)))
            continue
        name, labelnames = table[rng.integers(len(table))]
        labels = {k: str(rng.choice(LABEL_POOL)) for k in labelnames}
        if kind == "counter":
            value = float(rng.integers(1, 9)) if rng.random() < 0.5 else round(
                float(rng.uniform(0, 5)), 6)
        else:
            value = round(float(rng.choice([0.0, 0.001, 0.5, 1.0, 2.5]) if rng.random() < 0.3
                                else rng.exponential(0.3)), 6)
        ops.append((kind, name, labels, value))
    return ops


def apply(pkg, perf, ops) -> None:
    for op in ops:
        if op[0] == "perf":
            perf.record_metric(op[1], op[2], "ms")
            continue
        kind, name, labels, value = op
        inst = getattr(pkg, name)
        method = {"counter": "inc", "gauge": "set", "histogram": "observe"}[kind]
        getattr(inst, method)(value, **labels)


def without_help(text: str, families=HELP_DIFFERS) -> str:
    return "\n".join(ln for ln in text.split("\n")
                     if not (ln.startswith("# HELP ") and ln.split(" ")[2] in families))


@pytest.mark.parametrize("seed", range(6))
def test_render_is_byte_equal_after_the_same_operations(seed):
    ops = traffic(seed)
    apply(jobs, jax_perf(), ops)
    apply(pobs, port_perf(), ops)
    jtext, ptext = jobs.metrics_text(), pobs.metrics_text()
    assert without_help(ptext) == without_help(jtext)
    assert pobs.metrics_snapshot() == jobs.metrics_snapshot()


def test_only_the_compile_and_peak_help_lines_differ():
    for pkg in (jobs, pobs):
        pkg.COMPILES.inc(phase="warmup")
        pkg.COMPILE_SECONDS.observe(0.3, phase="warmup")
        pkg.POST_WARMUP_COMPILES.set(0)
        pkg.COMPILE_CACHE_EVENTS.inc(event="cache_hits")
        pkg.attribution.ATTR_MFU.set(0.1)
        pkg.attribution.ATTR_HBM_UTIL.set(0.2)
    jlines = set(jobs.metrics_text().split("\n"))
    plines = set(pobs.metrics_text().split("\n"))
    differ = {ln.split(" ")[2] for ln in jlines ^ plines}
    assert differ == HELP_DIFFERS
    assert all(ln.startswith("# HELP ") for ln in jlines ^ plines)
    port_help = "\n".join(ln for ln in plines if ln.startswith("# HELP "))
    assert "XLA" not in port_help and "v5e" not in port_help and "jax" not in port_help
    assert "H100" in port_help and "CUDA-graph" in port_help


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("seed", range(2))
def test_both_documents_pass_the_exposition_grammar(pkg, seed):
    ops = traffic(100 + seed) + [("histogram", "TTFT_SECONDS", {}, 0.3)]
    apply(jobs, jax_perf(), ops)
    apply(pobs, port_perf(), ops)
    text = (jobs if pkg == "jax" else pobs).metrics_text()
    types = conform(text)
    assert types["opsagent_ttft_seconds"] == "histogram"


def test_both_packages_declare_the_same_families():
    from opsagent_tpu.serving import decode_loop as jloop
    from opsagent_tpu_torch.serving import decode_loop as ploop

    jloop.record_dispatch("block", rows=2, steps=3)
    ploop.record_dispatch("block", rows=2, steps=3)
    jreg, preg = jobs.get_registry(), pobs.get_registry()
    assert set(preg._metrics) == set(jreg._metrics)
    for name, m in preg._metrics.items():
        j = jreg._metrics[name]
        assert (m.kind, m.labelnames) == (j.kind, j.labelnames), name
        assert getattr(m, "buckets", None) == getattr(j, "buckets", None), name


def test_escaped_label_values_round_trip():
    for pkg in (jobs, pobs):
        pkg.HTTP_REQUESTS.inc(method="GET", path='/we"ird\\path\nx', status="200")
    line = next(ln for ln in pobs.metrics_text().split("\n")
                if ln.startswith("opsagent_http_requests_total"))
    assert line == ('opsagent_http_requests_total{method="GET",'
                    'path="/we\\"ird\\\\path\\nx",status="200"} 1')
    assert line in jobs.metrics_text()


# -- traces --------------------------------------------------------------------
def build_trace(pkg, rid: str, seed: int, finish: bool = True):
    """One request's span tree with injected clocks: a root, a generate
    span per choice with queue_wait, prefill and a decode with block
    children, then detokenize."""
    rng = np.random.default_rng(seed)
    t = pkg.Trace(rid)
    t.started_at = 1_700_000_000.0 + seed
    base = 1000.0 + seed
    t.root.t0 = base
    cursor = base
    for i in range(int(rng.integers(1, 3))):
        g = t.root.start_child("generate", choice=i)
        g.t0 = cursor + 0.0001
        a = g.t0
        for name in ("queue_wait", "prefill"):
            b = a + float(rng.uniform(0.001, 0.05))
            g.child(name, a, b, **({"prompt_tokens": int(rng.integers(5, 500))}
                                   if name == "prefill" else {}))
            a = b
        d = g.start_child("decode")
        d.t0 = a
        for _ in range(int(rng.integers(1, 4))):
            b = a + float(rng.uniform(0.001, 0.03))
            d.child("decode_block", a, b, tokens=int(rng.integers(1, 33)))
            a = b
        d.close(tokens=7, finish_reason="stop")
        d.t1 = a
        g.close(tokens=7)
        g.t1 = a
        cursor = a
    det = t.root.start_child("detokenize")
    det.t0, det.t1 = cursor, cursor + 0.0005
    if finish:
        t.root.close()
        t.root.t1 = cursor + 0.001
        t.finished = True
    t.slo_class = "interactive"
    return t


@pytest.mark.parametrize("seed", range(4))
def test_trace_to_dict_and_format_tree_equal(seed):
    rid = f"chatcmpl-{seed:024d}"
    jt, pt = build_trace(jobs, rid, seed), build_trace(pobs, rid, seed)
    assert pt.to_dict() == jt.to_dict()
    assert pobs.format_tree(pt.to_dict()) == jobs.format_tree(jt.to_dict())
    assert pt.phase_totals_ms() == jt.phase_totals_ms()
    assert pobs.trace.class_of(pt.root) == jobs.trace.class_of(jt.root) == "interactive"


@pytest.mark.parametrize("anomalous", [False, True])
@pytest.mark.parametrize("p", [0.0, 1.0])
def test_tail_retention_decisions_equal(p, anomalous):
    out = {}
    for name, pkg in (("jax", jobs), ("port", pobs)):
        pkg.trace.set_sample_probability(p)
        t = build_trace(pkg, f"req-{p}-{anomalous}", 1, finish=False)
        pkg.get_store().add(t)
        if anomalous:
            pkg.trace.mark_anomalous(t.request_id, reason="ttft_breach")
        t.finish()
        kept = pkg.get_trace(t.request_id)
        out[name] = (kept is not None,
                     {d: pkg.TRACE_RETENTION.value(decision=d)
                      for d in ("kept_anomalous", "kept_sampled", "dropped")},
                     t.anomaly_reason)
        pkg.trace.set_sample_probability(None)
    assert out["port"] == out["jax"]
    assert out["port"][0] == (anomalous or p == 1.0)


# -- timeline -----------------------------------------------------------------
def build_timeline_inputs(pkg, rid: str, seed: int):
    t = build_trace(pkg, rid, seed)
    pkg.get_store().add(t)
    rec = pkg.flight.get_recorder()
    base = t.root.t0
    events = [("admission", {"seq_id": 3, "prompt_tokens": 40, "request_id": rid}, 0.0002),
              ("dispatch", {"op": "mixed", "decode_seq_ids": [], "prefill_seq_ids": [3]},
               0.004),
              ("ttft", {"seq_id": 3, "ttft_ms": 4.0, "request_id": rid}, 0.005),
              ("dispatch", {"op": "decode_block", "seq_ids": [3], "steps": 8}, 0.02),
              ("tool_exec", {"phase": "enter", "tool": "kubectl", "request_id": rid}, 0.03),
              ("tool_exec", {"phase": "exit", "tool": "kubectl", "outcome": "ok",
                             "request_id": rid}, 0.04),
              ("finish", {"seq_id": 3, "tokens": 9, "request_id": rid}, 0.05),
              ("admission", {"seq_id": 9, "prompt_tokens": 2, "request_id": "other"}, 0.01)]
    for kind, fields, dt in events:
        e = rec.record(kind, **fields)
        e["ts"], e["wall"] = base + dt, 1_700_000_000.0 + dt
    return t


@pytest.mark.parametrize("seed", range(4))
def test_timeline_assemble_and_gantt_equal(seed):
    rid = f"chatcmpl-tl{seed}"
    build_timeline_inputs(jobs, rid, seed)
    build_timeline_inputs(pobs, rid, seed)
    jt, pt = jobs.timeline.assemble(rid), pobs.timeline.assemble(rid)
    assert pt == jt
    assert pt["goodput"]["coverage"] >= 0.95
    assert pobs.timeline.render_gantt(pt) == jobs.timeline.render_gantt(jt)
    assert pobs.timeline.assemble("unknown") is None is jobs.timeline.assemble("unknown")


def test_stitch_fleet_and_its_gantt_equal():
    rid = "chatcmpl-fleet"
    build_timeline_inputs(jobs, rid, 2)
    src = jobs.timeline.assemble(rid)
    journey = {"t0_wall": src["t0_wall"] - 0.003, "shape": "failover",
               "replicas": ["r1", "r2"],
               "hops": [{"replica": "r1", "wall": src["t0_wall"] - 0.002},
                        {"replica": "r2", "wall": src["t0_wall"] + 0.02}]}
    events = [{"kind": "failover", "wall": src["t0_wall"] + 0.015, "replica": "r1"},
              {"kind": "page_fault_in", "phase": "enter", "wall": src["t0_wall"] + 0.021},
              {"kind": "page_fault_in", "phase": "exit", "wall": src["t0_wall"] + 0.022,
               "replica": "r1", "outcome": "ok", "pages": 3}]
    kw = dict(journey=journey, offsets={"r2": 0.0015}, reaped=["r3"], events=events)
    sources = {"r1": src, "r2": {**src, "t0_wall": src["t0_wall"] + 0.02}}
    got = pobs.timeline.stitch_fleet(rid, sources, **kw)
    want = jobs.timeline.stitch_fleet(rid, sources, **kw)
    assert got == want
    assert pobs.timeline.render_fleet_gantt(got) == jobs.timeline.render_fleet_gantt(want)


# -- SLO ----------------------------------------------------------------------
def slo_scenario(pkg, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for v in rng.exponential(0.4, int(rng.integers(0, 30))):
        pkg.TTFT_SECONDS.observe(round(float(v), 6))
    for v in rng.exponential(0.02, int(rng.integers(0, 60))):
        pkg.ITL_SECONDS.observe(round(float(v), 6))
    for outcome in ("completed", "error", "timeout", "admission_failed"):
        n = int(rng.integers(0, 5 if outcome == "completed" else 2))
        if n:
            pkg.ENGINE_REQUESTS.inc(n, outcome=outcome)
    for cls in pkg.SLO_CLASSES:
        for outcome in ("completed", "shed"):
            n = int(rng.integers(0, 3))
            if n:
                pkg.CLASS_REQUESTS.inc(n, **{"class": cls, "outcome": outcome})
        pkg.CLASS_TTFT_SECONDS.observe(round(float(rng.uniform(0, 2)), 6), **{"class": cls})


def strip_times(v):
    if isinstance(v, dict):
        return {k: strip_times(x) for k, x in v.items()
                if k not in ("evaluated_at", "breached_for_s")}
    if isinstance(v, list):
        return [strip_times(x) for x in v]
    return v


@pytest.mark.parametrize("targets", [None, {"OPSAGENT_SLO_TTFT_MS": "150",
                                            "OPSAGENT_SLO_ITL_MS": "5",
                                            "OPSAGENT_SLO_ERROR_RATE": "0.2"}])
@pytest.mark.parametrize("seed", range(4))
def test_slo_evaluate_equal_on_the_same_samples(seed, targets, monkeypatch):
    for k, v in (targets or {}).items():
        monkeypatch.setenv(k, v)
    slo_scenario(jobs, seed)
    slo_scenario(pobs, seed)
    got, want = pobs.slo.evaluate(), jobs.slo.evaluate()
    assert strip_times(got) == strip_times(want)
    assert [ln for ln in pobs.slo.get_watchdog().collect()] == \
        [ln for ln in jobs.slo.get_watchdog().collect()]


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.95, 1.0])
def test_histogram_quantile_equal(q):
    slo_scenario(jobs, 7)
    slo_scenario(pobs, 7)
    assert pobs.slo.histogram_quantile(pobs.TTFT_SECONDS, q) == \
        jobs.slo.histogram_quantile(jobs.TTFT_SECONDS, q)


@pytest.mark.parametrize("body,scenario", [
    ({"slo_class": "batch"}, ""), ({"slo_class": "bogus", "scenario": "audit"}, ""),
    (None, "diagnose"), ({}, ""), ({"scenario": "Execute"}, ""),
])
def test_slo_classify_equal(body, scenario):
    assert pobs.slo.classify(body, scenario) == jobs.slo.classify(body, scenario)


def test_slo_chip_count_is_the_cuda_device_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pobs.slo._chip_count() == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert pobs.slo._chip_count() == 1


# -- history ------------------------------------------------------------------
def walk_history(pkg, seed: int):
    rng = np.random.default_rng(seed)
    h = pkg.history.TelemetryHistory(max_bytes=40_000)
    box = {"c": 0.0, "g": 0.0}
    h.register("c", "counter", lambda: box["c"])
    h.register("g", "gauge", lambda: box["g"])
    now = 1_700_000_000.0
    for _ in range(900):
        now += float(rng.choice([1.0, 1.0, 2.0, 7.0]))
        box["c"] += float(rng.integers(0, 40))
        box["g"] = round(float(rng.uniform(0, 1)), 4)
        h.sample(now)
    return h, now


@pytest.mark.parametrize("since,step", [(60.0, None), (600.0, 10.0), (7200.0, 60.0),
                                        (1e9, None), (300.0, 30.0)])
def test_history_query_equal_with_an_injected_now(since, step):
    jh, now = walk_history(jobs, 3)
    ph, pnow = walk_history(pobs, 3)
    assert pnow == now
    kw = dict(since=since, step=step, now=now)
    assert ph.query(**kw) == jh.query(**kw)
    assert ph.rate("c", 120.0, now=now) == jh.rate("c", 120.0, now=now)
    assert ph.window_sum("c", 3600.0, now=now) == jh.window_sum("c", 3600.0, now=now)
    assert ph.stats() == jh.stats()


@pytest.mark.parametrize("q", [{}, {"series": "a, b,,c", "since": "60", "step": "5"},
                               {"since": "x"}, {"step": "1e3"}])
def test_history_parse_query_equal(q):
    def parse(pkg):
        try:
            return pkg.history.parse_query(q)
        except ValueError as e:
            return type(e).__name__
    assert parse(pobs) == parse(jobs)


def test_history_default_series_equal():
    assert pobs.history.get_history().series_names() == \
        jobs.history.get_history().series_names()


# -- attribution ---------------------------------------------------------------
def attr_pair(quantize, kv_quantize, weight_stream, preset="bench-8b"):
    cfg = pconfig.get_config_preset(preset)
    kw = dict(num_params=cfg.num_params(), num_layers=cfg.num_layers,
              num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim_, vocab_size=cfg.vocab_size, dtype_bytes=2,
              quantize=quantize, kv_quantize=kv_quantize, weight_stream=weight_stream,
              hbm_gbps=3350.0, peak_tflops=989.0)
    return (jobs.attribution.Attribution(**kw), pobs.attribution.Attribution(**kw))


COMPOSITIONS = [  # (weight_streams, q_tokens, kv_read, kv_write, attn_q_ctx, copy_bytes)
    (1, 8, 8 * 900, 8, 8 * 900, 0.0),
    (32, 256, 256 * 1200, 256, 256 * 1200, 0.0),
    (1, 300, 44_000, 300, 45_150, 1024.0),
    (7, 0, 0, 0, 0, 0.0),
]


@pytest.mark.parametrize("weight_stream", ["xla", "pallas-dma"])
@pytest.mark.parametrize("quantize,kv_quantize", [("", ""), ("int8", "int8"), ("int4", "int8"),
                                                  ("", "int8")])
def test_attribution_cost_and_snapshot_equal(quantize, kv_quantize, weight_stream,
                                              monkeypatch):
    ja, pa = attr_pair(quantize, kv_quantize, weight_stream)
    for comp in COMPOSITIONS:
        kw = dict(zip(("weight_streams", "q_tokens", "kv_read_tokens", "kv_write_tokens",
                       "attn_q_ctx", "copy_bytes"), comp))
        assert pa.cost(**kw) == ja.cost(**kw)
    # The same dispatches on the same clock: snapshot and gauges equal.
    snaps = {}
    for name, a, pkg in (("jax", ja, jobs), ("port", pa, pobs)):
        clock = iter(np.arange(1.0, 100.0, 0.25).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        for comp, measured in zip(COMPOSITIONS, (0.02, 0.05, None, 0.01)):
            a.dispatch("block", **dict(zip(("weight_streams", "q_tokens", "kv_read_tokens",
                                            "kv_write_tokens", "attn_q_ctx", "copy_bytes"),
                                           comp)), measured_s=measured)
        monkeypatch.undo()
        snaps[name] = a.snapshot()
    assert snaps["port"] == snaps["jax"]
    assert 0 < snaps["port"]["mfu"] and 0 < snaps["port"]["hbm_utilization"]


@pytest.mark.parametrize("weight_stream", ["xla", "pallas-dma"])
@pytest.mark.parametrize("kv_quantize", ["", "int8"])
@pytest.mark.parametrize("quantize", ["", "int8", "int4"])
@pytest.mark.parametrize("preset", PRESETS)
def test_attribution_for_engine_equal(preset, quantize, kv_quantize, weight_stream):
    import jax.numpy as jnp

    from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
    from opsagent_tpu_torch.serving.engine import EngineConfig

    j = jobs.attribution.Attribution.for_engine(
        jconfig.get_config_preset(preset),
        JaxEngineConfig(dtype=jnp.bfloat16, quantize=quantize, kv_quantize=kv_quantize),
        weight_stream=weight_stream)
    p = pobs.attribution.Attribution.for_engine(
        pconfig.get_config_preset(preset),
        EngineConfig(dtype=torch.bfloat16, quantize=quantize, kv_quantize=kv_quantize),
        weight_stream=weight_stream)
    for key in ("num_params", "weight_stream_bytes", "kv_token_bytes", "logits_bytes",
                "weight_stream", "num_layers", "num_heads", "head_dim"):
        assert getattr(p, key) == getattr(j, key), key
    # Defaults: the port's are the H100's, the JAX package's the v5e's.
    assert (p.hbm_bytes_s, p.peak_flops_s) == (3350e9, 989e12)
    assert (j.hbm_bytes_s, j.peak_flops_s) == (820e9, 197e12)


def test_attribution_peaks_follow_the_environment(monkeypatch):
    monkeypatch.setenv("OPSAGENT_HBM_GBPS", "2000")
    monkeypatch.setenv("OPSAGENT_PEAK_TFLOPS", "500")
    p = attr_pair("", "", "xla")[1]
    assert (p.hbm_bytes_s, p.peak_flops_s) == (2000e9, 500e12)
    assert pobs.attribution.DEFAULT_HBM_GBPS == 3350.0
    assert pobs.attribution.DEFAULT_PEAK_TFLOPS == 989.0


@pytest.mark.parametrize("phase", ["queued", "prefill", "decode_active"])
def test_record_goodput_and_copy_equal(phase):
    for pkg in (jobs, pobs):
        pkg.attribution.record_goodput(0.25, phase, slo_class="batch")
        pkg.attribution.record_goodput(0.0, phase)
        pkg.attribution.record_copy(4096, "out", 0.002)
    assert pobs.metrics_snapshot() == jobs.metrics_snapshot()


# -- compile watchdog -----------------------------------------------------------
class _FakeGraph:
    """Stand-in of ``torch.cuda.CUDAGraph`` on the CPU: the body runs once,
    at "capture", as a real capture runs it."""

    def register_generator_state(self, generator):
        pass


class _Capture:
    def __init__(self, graph):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Cache:
    def buffers(self):
        return ()


def capture_step_graph(monkeypatch):
    from opsagent_tpu_torch.serving.decode_graph import StepGraph

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    ran = []
    StepGraph(lambda: ran.append(1), (), _Cache())
    assert ran == [1]


def build_kernel(monkeypatch, tmp_path, cached: bool):
    """``cuda_build.build`` of a stand-in source with a stand-in nvcc that
    writes its -o file; ``cached`` builds it once beforehand (and resets
    the counters that build left)."""
    from opsagent_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    csrc.mkdir(exist_ok=True)
    (csrc / "k.cu").write_text("// kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    if cached:
        cuda_build.build("k.cu")
        pobs.get_registry().reset()
        pobs.flight.get_recorder().reset()
    path, _ = cuda_build.build("k.cu")
    assert path.exists()


def jax_compile(duration=0.5):
    jobs.flight._on_duration_event("/jax/core/compile/backend_compile_duration", duration)


@pytest.mark.parametrize("phase", ["startup", "warmup", "serving"])
@pytest.mark.parametrize("source", ["cuda_graph", "nvcc", "cached_build"])
def test_compile_watchdog_phases_and_anomaly(source, phase, monkeypatch, tmp_path):
    def port_compile():
        if source == "cuda_graph":
            capture_step_graph(monkeypatch)
        else:
            build_kernel(monkeypatch, tmp_path, cached=source == "cached_build")

    compiles = source != "cached_build"
    for pkg, run in ((jobs, jax_compile if compiles else lambda: None), (pobs, port_compile)):
        if phase == "serving":
            with pkg.flight.warmup_phase():
                pass
        if phase == "warmup":
            with pkg.flight.warmup_phase():
                run()
        else:
            run()
    for pkg in (jobs, pobs):
        assert pkg.COMPILES.value(phase=phase) == int(compiles)
        assert pkg.COMPILE_SECONDS.count(phase=phase) == int(compiles)
        assert pkg.POST_WARMUP_COMPILES.value() == int(compiles and phase == "serving")
        assert pkg.ANOMALIES.value(reason="post_warmup_compile") == \
            int(compiles and phase == "serving")
        kinds = [(e["kind"], e.get("phase", e.get("reason")))
                 for e in pkg.flight.get_recorder().snapshot()]
        want = [("compile", phase)] if compiles else []
        if compiles and phase == "serving":
            want.append(("anomaly", "post_warmup_compile"))
        assert kinds == want
    events = pobs.flight.get_recorder().snapshot(kind="compile")
    if compiles:
        assert events[0]["what"] == source
    if source != "cuda_graph":
        hit = "cache_hits" if source == "cached_build" else "cache_misses"
        assert pobs.COMPILE_CACHE_EVENTS.value(event=hit) == 1


def test_warmup_phase_nests_and_a_failed_warmup_leaves_the_process_unwarmed():
    for pkg in (jobs, pobs):
        with pytest.raises(RuntimeError):
            with pkg.flight.warmup_phase():
                assert pkg.flight.compile_phase() == "warmup"
                raise RuntimeError("capture failed")
        assert pkg.flight.compile_phase() == "startup" and not pkg.flight.warmed()
        with pkg.flight.warmup_phase(), pkg.flight.warmup_phase():
            pass
        assert pkg.flight.compile_phase() == "serving"


# -- flight ring -----------------------------------------------------------------
def test_flight_ring_sampling_and_dump_equal(tmp_path):
    out = {}
    for name, pkg in (("jax", jobs), ("port", pobs)):
        rec = pkg.flight.FlightRecorder(capacity=8, dump_interval_s=0.0)
        rec.anomaly_hold_s = 0.0
        rec.set_sample_rate("dispatch", 3)
        for i in range(20):
            rec.record("dispatch", op="mixed", i=i)
            rec.record("admission", seq_id=i)
        path = rec.anomaly("request_error", request_id="req-x", error="boom")
        if pkg is pobs:
            rec.wait_dumps(timeout=30)   # the port writes dumps on a thread
        lines = [json.loads(ln) for ln in open(path)]
        strip = [{k: v for k, v in e.items() if k not in ("ts", "wall")} for e in lines]
        stats = rec.stats()
        stats.pop("last_dump_path")
        out[name] = ([{k: v for k, v in e.items() if k not in ("ts", "wall")}
                      for e in rec.snapshot(n=5)], stats, strip[0]["reason"],
                     [e["kind"] for e in strip])
        assert pkg.flight.request_id_of(None) is None
    assert out["port"] == out["jax"]


# -- configs and profiling --------------------------------------------------------
@pytest.mark.parametrize("preset", PRESETS)
def test_num_params_equal_for_presets(preset):
    assert pconfig.get_config_preset(preset).num_params() == \
        jconfig.get_config_preset(preset).num_params()


@pytest.mark.parametrize("fixture", DENSE_FIXTURES)
def test_num_params_equal_for_hf_fixtures(fixture):
    path = os.path.join(FIXTURES, fixture)
    assert pconfig.config_from_hf(path).num_params() == \
        jconfig.config_from_hf(path).num_params()


def test_timed_capture_writes_a_cpu_trace(tmp_path):
    out = profiling.timed_capture(0.2, str(tmp_path))
    assert out == str(tmp_path)
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert events


def test_profiling_guards(tmp_path, monkeypatch):
    monkeypatch.delenv("OPSAGENT_PROFILE_DIR", raising=False)
    with pytest.raises(ValueError):
        profiling.timed_capture(0)
    with pytest.raises(ValueError):
        profiling.timed_capture(profiling.MAX_CAPTURE_SECONDS + 1)
    with pytest.raises(profiling.ProfilingDisabled):
        profiling.timed_capture(0.1)
    profiling.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiling.start_trace(str(tmp_path))
    finally:
        assert profiling.stop_trace().startswith(str(tmp_path))
    with pytest.raises(RuntimeError, match="no profile capture"):
        profiling.stop_trace()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.save_device_memory_profile(str(tmp_path / "m.pickle"))


def test_annotate_and_device_timer_record_only_when_asked(monkeypatch):
    with profiling.annotate("engine.mixed_step"):
        pass
    out = []
    with profiling.device_timer("mixed_step", out):
        out.append(torch.ones(2))
    assert "device.mixed_step" not in port_perf().get_stats()
    monkeypatch.setenv("OPSAGENT_DEVICE_TIMING", "1")
    with profiling.device_timer("mixed_step", out):
        out.append(torch.ones(2))
    assert port_perf().get_stats()["device.mixed_step"]["count"] == 1


def test_logger_and_perf_are_copies():
    from opsagent_tpu.utils import logger as jlog
    from opsagent_tpu.utils import perf as jperf
    from opsagent_tpu_torch.utils import logger as plog
    from opsagent_tpu_torch.utils import perf as pperf

    for a, b in ((jperf.PerfStats, pperf.PerfStats), (jlog.JSONFormatter, plog.JSONFormatter)):
        assert sorted(vars(a)) == sorted(vars(b))
    j, p = jperf.PerfStats(), pperf.PerfStats()
    for s in (j, p):
        for v in (3.0, 1.0, 2.0, 10.0):
            s.record_metric("x", v)
        s.set_gauge("g", 4.0)
    assert p.get_stats() == j.get_stats()
    assert p.format_table() == j.format_table()


def test_an_anomaly_dump_is_written_off_the_callers_thread(tmp_path):
    """The port's caller copies the ring and returns: a writer thread
    writes what the ring held at the anomaly, and its context."""
    rec = pobs.flight.FlightRecorder(capacity=64, dump_interval_s=0.0)
    t = build_trace(pobs, "req-dump", 0)
    pobs.get_store().add(t)
    for i in range(10):
        rec.record("dispatch", op="mixed", i=i)
    path = rec.anomaly("ttft_breach", request_id="req-dump", ttft_ms=900.0)
    rec.record("dispatch", op="mixed", i=99)
    rec.wait_dumps(timeout=30)
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0]["kind"] == "dump_header" and lines[0]["events"] == 11
    assert [e.get("i") for e in lines[1:11]] == list(range(10))
    assert {e["kind"] for e in lines[12:]} >= {"attribution_snapshot", "timeline"}
    assert rec.last_dump_path == path and rec.anomaly("ttft_breach") is not None
    rec.wait_dumps(timeout=30)


@pytest.mark.parametrize("labels", [{}, {"outcome": "ok", "extra": "x"}, {"outcom": "ok"},
                                    {"outcome": "ok"}])
def test_label_sets_checked_as_jax_does(labels):
    def outcome(pkg):
        try:
            pkg.ENGINE_REQUESTS.inc(**labels)
            return pkg.ENGINE_REQUESTS.value(**labels)
        except ValueError as e:
            return str(e)
    assert outcome(pobs) == outcome(jobs)
