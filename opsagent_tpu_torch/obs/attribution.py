"""Goodput ledger, part 1: continuous roofline attribution (the port's copy
of ``opsagent_tpu/obs/attribution.py``, at the H100's peaks).

An offline profiler trace says where one run's device time went. This
module makes that attribution continuous: a static cost model (derived
from the model config and the engine's quantization choices) prices every
device dispatch from its batch composition, on host, with no device work
and no capture — the zero-post-warmup-compiles invariant is untouched
because attribution never sees a tensor.

The model is a ROOFLINE: per dispatch it answers "how many HBM bytes did
this step *have* to move" (weights streamed, KV read, KV written, logits
materialized) and "how many useful model FLOPs did it perform", assuming
perfectly-coalesced access. Reality is worse (norms, rope, cache writes
and the sampler each launch their own kernels), and that gap is the
point: ``opsagent_attr_model_drift_ratio`` (measured / modeled step
time) is the live number that says how far the kernels sit from the
bytes floor, so an int4/int8-KV PR can watch its denominator move
without re-running a manual trace.

Known approximations (documented, deliberate):

- Parameter count uses ``ModelConfig.num_params()`` (dense-architecture
  arithmetic): MoE all-expert decode streams more, MLA projections
  differ. The drift gauge absorbs the error for such models.
- Prefill attention FLOPs use the exact causal sum per chunk
  (``chunk*start + chunk*(chunk+1)/2`` attended positions); KV-read
  bytes assume each resident token's K/V is streamed once per dispatch
  (the paged kernels' design goal — a gather over the page table can
  read its capacity instead, which again shows up as drift).
- A decode block streams the weights once per step (``n_steps`` times
  per block call), regardless of how few lanes carry a budget — inactive
  lanes still ride the stream.

Per-request goodput rides here too: ``opsagent_goodput_seconds_total``
accumulates wall seconds by lifecycle phase (queued / prefill /
decode_active / tool_blocked), recorded from the scheduler, engine, and
agent loop, so "what fraction of serving wall clock was useful decode"
is a scrape-side division (obs/timeline.py computes the same split per
request).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Any

from .metrics import get_registry

_reg = get_registry()

# -- instruments (names are a docs/observability.md contract) ----------------
ATTR_BYTES = _reg.counter(
    "opsagent_attr_bytes_total",
    "Modeled HBM bytes moved by device dispatches, by kind (weights = "
    "serial parameter stream, weights_prefetch = parameter stream moved "
    "by the double-buffered pallas-dma weight pipeline (overlapped with "
    "compute), kv_read / kv_write = paged-cache traffic, other = "
    "logit materialization + offload page copies). Roofline arithmetic "
    "from the dispatch composition — no device measurement involved",
    labelnames=("kind",),
)
ATTR_STEP_BYTES = _reg.gauge(
    "opsagent_attr_step_bytes",
    "Modeled bytes of the MOST RECENT device dispatch, by kind — the "
    "live bytes-per-step split (weights vs KV-read vs KV-write vs other)",
    labelnames=("kind",),
)
ATTR_FLOPS = _reg.counter(
    "opsagent_attr_flops_total",
    "Modeled useful model FLOPs (2*params per processed token plus exact "
    "causal attention terms)",
)
ATTR_DISPATCHES = _reg.counter(
    "opsagent_attr_dispatches_total",
    "Dispatches priced by the attribution cost model, by op",
    labelnames=("op",),
)
ATTR_MODELED_STEP_SECONDS = _reg.gauge(
    "opsagent_attr_modeled_step_seconds",
    "Roofline-modeled wall time of the most recent dispatch "
    "(modeled bytes / configured HBM bandwidth)",
)
ATTR_MEASURED_STEP_SECONDS = _reg.histogram(
    "opsagent_attr_measured_step_seconds",
    "Measured dispatch+pull wall time for synchronously-pulled ops "
    "(mixed tick, single step) — the numerator of the drift ratio",
    labelnames=("op",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5),
)
ATTR_MODEL_DRIFT = _reg.gauge(
    "opsagent_attr_model_drift_ratio",
    "EMA of measured / modeled step time on synchronously-measured "
    "dispatches: 1.0 = running at the bytes roofline; large values mean "
    "the kernels (or host gaps) sit far above the bytes floor",
)
ATTR_MFU = _reg.gauge(
    "opsagent_attr_mfu",
    "Model FLOP utilization over the rate window: modeled useful FLOP/s "
    "divided by OPSAGENT_PEAK_TFLOPS (default 989, H100 SXM dense bf16)",
)
ATTR_HBM_UTIL = _reg.gauge(
    "opsagent_attr_hbm_utilization",
    "Modeled HBM-bandwidth utilization over the rate window: modeled "
    "bytes/s divided by OPSAGENT_HBM_GBPS (default 3350, H100 SXM HBM3)",
)
GOODPUT_SECONDS = _reg.counter(
    "opsagent_goodput_seconds_total",
    "Request wall seconds by lifecycle phase (queued = admission queue, "
    "prefill = admission to first token, decode_active = first token to "
    "finish, tool_blocked = agent tool subprocess window). The goodput "
    "split: decode_active over the total is the fraction of serving "
    "wall clock spent producing tokens",
    labelnames=("phase",),
)

_ENV_HBM = "OPSAGENT_HBM_GBPS"
_ENV_TFLOPS = "OPSAGENT_PEAK_TFLOPS"
# NVIDIA H100 SXM5 80 GB at its 700 W power limit, spec sheet: HBM3
# bandwidth and dense (no sparsity) bf16 tensor-core peak. A card set
# below 700 W runs slower under load; OPSAGENT_HBM_GBPS and
# OPSAGENT_PEAK_TFLOPS override both.
DEFAULT_HBM_GBPS = 3350.0
DEFAULT_PEAK_TFLOPS = 989.0
RATE_WINDOW_S = 60.0

_BYTE_KINDS = ("weights", "weights_prefetch", "kv_read", "kv_write", "other")


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, ""))
        return v if v > 0 else default
    except ValueError:
        return default


def prefill_attn_positions(start: int, chunk: int) -> int:
    """Exact causal attended-position count for one prefill chunk: query
    token j (0-based within the chunk) attends start + j + 1 positions."""
    return chunk * start + chunk * (chunk + 1) // 2


class Attribution:
    """Static roofline cost model for ONE engine's dispatches.

    All methods are cheap host float math under a small lock; safe to
    call from the engine's dispatch loop. Construction derives the
    per-dispatch byte/FLOP coefficients once from the model config and
    the engine's quantization choices.
    """

    def __init__(
        self,
        *,
        num_params: int,
        num_layers: int,
        num_heads: int,
        num_kv_heads: int,
        head_dim: int,
        vocab_size: int,
        dtype_bytes: int = 2,
        quantize: str = "",
        kv_quantize: str = "",
        weight_stream: str = "",
        mla_latent_dim: int = 0,
        hbm_gbps: float | None = None,
        peak_tflops: float | None = None,
    ):
        self.num_params = int(num_params)
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.vocab_size = vocab_size
        # Weight bytes streamed per forward pass. int8: 1 byte/param plus
        # ~2 % per-channel scales (PERF.md: "~8 GB int8 (+1-2 % scales)");
        # int4: a packed nibble plus one f32 scale per 128-group.
        if quantize == "int8":
            bpp = 1.02
        elif quantize == "int4":
            bpp = 0.5 + 4.0 / 128.0
        else:
            bpp = float(dtype_bytes)
        self.weight_stream_bytes = self.num_params * bpp
        # "pallas-dma" (the JAX package's name, kept so both ledgers read
        # alike): the quantized matmul kernel streams weight tiles through
        # its cp.async ring while mma.sync runs, overlapping the parameter
        # stream with compute. Bytes land under kind="weights_prefetch"
        # and modeled_s becomes the overlapped roofline
        # max(bytes/bw, flops/peak) instead of the serial bytes/bw.
        self.weight_stream = weight_stream or "xla"
        # KV bytes per resident token across ALL layers. Standard paged
        # cache: k + v planes of [num_kv_heads, head_dim]; int8 pages add
        # one f32 scale per token per head per plane. MLA latent cache:
        # one shared latent vector per token (the ~85x compression).
        if mla_latent_dim:
            per_layer = mla_latent_dim * dtype_bytes
        elif kv_quantize == "int8":
            per_layer = 2 * num_kv_heads * (head_dim * 1 + 4)
        else:
            per_layer = 2 * num_kv_heads * head_dim * dtype_bytes
        self.kv_token_bytes = num_layers * per_layer
        # "other": the logits each sampled row materializes (f32 [V] per
        # query token that reaches the sampler).
        self.logits_bytes = vocab_size * 4
        self.hbm_bytes_s = _env_float(_ENV_HBM, hbm_gbps or DEFAULT_HBM_GBPS) * 1e9
        self.peak_flops_s = (
            _env_float(_ENV_TFLOPS, peak_tflops or DEFAULT_PEAK_TFLOPS) * 1e12
        )
        self._lock = threading.Lock()
        self._window: deque[tuple[float, float, float]] = deque()
        self._cum_flops = 0.0
        self._cum_bytes = 0.0
        self._drift_ema: float | None = None
        self.dispatches = 0

    @classmethod
    def for_engine(
        cls, model_cfg: Any, engine_cfg: Any, weight_stream: str = ""
    ) -> "Attribution":
        """Derive the cost model from an Engine's (model_cfg, cfg) pair.
        ``weight_stream`` is the engine's RESOLVED weight stream:
        "pallas-dma" when every projection runs through the quantized
        matmul kernel, "xla" for ``torch.matmul`` (bytes/bw)."""
        try:
            dtype_bytes = int(engine_cfg.dtype.itemsize)
        except AttributeError:
            dtype_bytes = 2
        mla = getattr(model_cfg, "mla", None)
        latent = (
            mla.latent_dim if mla is not None and mla.latent_cache else 0
        )
        return cls(
            num_params=model_cfg.num_params(),
            num_layers=model_cfg.num_layers,
            num_heads=model_cfg.num_heads,
            num_kv_heads=model_cfg.num_kv_heads,
            head_dim=model_cfg.head_dim_,
            vocab_size=model_cfg.vocab_size,
            dtype_bytes=dtype_bytes,
            quantize=getattr(engine_cfg, "quantize", ""),
            kv_quantize=getattr(engine_cfg, "kv_quantize", ""),
            weight_stream=weight_stream,
            mla_latent_dim=latent,
        )

    # -- pricing -------------------------------------------------------------
    def cost(
        self,
        *,
        weight_streams: float = 1.0,
        q_tokens: int = 0,
        kv_read_tokens: int = 0,
        kv_write_tokens: int = 0,
        attn_q_ctx: int = 0,
        copy_bytes: float = 0.0,
    ) -> dict[str, float]:
        """The closed-form arithmetic: bytes by kind, FLOPs, and the
        bandwidth-roofline modeled seconds for one dispatch. Pure — the
        unit tests drive this directly against hand arithmetic."""
        b_weights = weight_streams * self.weight_stream_bytes
        b_kv_read = kv_read_tokens * self.kv_token_bytes
        b_kv_write = kv_write_tokens * self.kv_token_bytes
        b_other = q_tokens * self.logits_bytes + copy_bytes
        total = b_weights + b_kv_read + b_kv_write + b_other
        flops = (
            2.0 * self.num_params * q_tokens
            + 4.0 * self.num_heads * self.head_dim * self.num_layers
            * attn_q_ctx
        )
        overlapped = self.weight_stream == "pallas-dma"
        # Overlap-aware roofline: under pallas-dma the weight stream is
        # double-buffered behind compute, so a dispatch's floor is the
        # SLOWER of "move every byte" and "do every FLOP" rather than
        # their serial bytes-only sum — the same total bytes, but the
        # kernel earns credit for hiding DMA issue latency only up to
        # the bandwidth/compute roofline, never below it.
        modeled_s = total / self.hbm_bytes_s
        if overlapped:
            modeled_s = max(modeled_s, flops / self.peak_flops_s)
        return {
            "weights": 0.0 if overlapped else b_weights,
            "weights_prefetch": b_weights if overlapped else 0.0,
            "kv_read": b_kv_read,
            "kv_write": b_kv_write,
            "other": b_other,
            "total": total,
            "flops": flops,
            "modeled_s": modeled_s,
        }

    def dispatch(
        self,
        op: str,
        *,
        weight_streams: float = 1.0,
        q_tokens: int = 0,
        kv_read_tokens: int = 0,
        kv_write_tokens: int = 0,
        attn_q_ctx: int = 0,
        copy_bytes: float = 0.0,
        measured_s: float | None = None,
    ) -> dict[str, float]:
        """Price one dispatch and fold it into the ledger: cumulative
        byte/FLOP counters, the live bytes-per-step split, the MFU / HBM
        utilization rate-window gauges, and (when the caller measured the
        dispatch synchronously) the modeled-vs-measured drift. Never
        raises into the serving path."""
        c = self.cost(
            weight_streams=weight_streams,
            q_tokens=q_tokens,
            kv_read_tokens=kv_read_tokens,
            kv_write_tokens=kv_write_tokens,
            attn_q_ctx=attn_q_ctx,
            copy_bytes=copy_bytes,
        )
        try:
            self._record(op, c, measured_s)
        except Exception:  # noqa: BLE001 - the ledger must not kill serving
            pass
        return c

    def _record(
        self, op: str, c: dict[str, float], measured_s: float | None
    ) -> None:
        ATTR_DISPATCHES.inc(op=op)
        for kind in _BYTE_KINDS:
            if c[kind]:
                ATTR_BYTES.inc(c[kind], kind=kind)
            ATTR_STEP_BYTES.set(c[kind], kind=kind)
        ATTR_FLOPS.inc(c["flops"])
        ATTR_MODELED_STEP_SECONDS.set(c["modeled_s"])
        now = time.perf_counter()
        with self._lock:
            self.dispatches += 1
            self._cum_flops += c["flops"]
            self._cum_bytes += c["total"]
            self._window.append((now, self._cum_flops, self._cum_bytes))
            while (
                len(self._window) > 2
                and now - self._window[0][0] > RATE_WINDOW_S
            ):
                self._window.popleft()
            t0, f0, b0 = self._window[0]
            dt = now - t0
            # Materialized even before the window has two points: an
            # absent gauge and "no recent work" must not look the same.
            ATTR_MFU.set(
                (self._cum_flops - f0) / dt / self.peak_flops_s
                if dt > 0 else 0.0
            )
            ATTR_HBM_UTIL.set(
                (self._cum_bytes - b0) / dt / self.hbm_bytes_s
                if dt > 0 else 0.0
            )
            if measured_s is not None and c["modeled_s"] > 0:
                ATTR_MEASURED_STEP_SECONDS.observe(measured_s, op=op)
                ratio = measured_s / c["modeled_s"]
                if math.isfinite(ratio):
                    ema = self._drift_ema
                    self._drift_ema = (
                        ratio if ema is None else 0.9 * ema + 0.1 * ratio
                    )
                    ATTR_MODEL_DRIFT.set(self._drift_ema)

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """Compact dict for bench `extra.attribution` and flight dumps."""
        with self._lock:
            drift = self._drift_ema
            cum_f, cum_b = self._cum_flops, self._cum_bytes
            n = self.dispatches
        return {
            "weight_stream": self.weight_stream,
            "weight_stream_bytes": round(self.weight_stream_bytes),
            "kv_token_bytes": round(self.kv_token_bytes),
            "hbm_gbps": round(self.hbm_bytes_s / 1e9, 1),
            "peak_tflops": round(self.peak_flops_s / 1e12, 1),
            "dispatches": n,
            "bytes_total": round(cum_b),
            "flops_total": round(cum_f),
            "bytes_by_kind": {
                k: round(ATTR_BYTES.value(kind=k)) for k in _BYTE_KINDS
            },
            "mfu": round(ATTR_MFU.value(), 6),
            "hbm_utilization": round(ATTR_HBM_UTIL.value(), 6),
            "modeled_last_step_s": round(
                ATTR_MODELED_STEP_SECONDS.value(), 6
            ),
            "drift_ema": None if drift is None else round(drift, 3),
        }


# -- process-wide access ------------------------------------------------------
# One engine per process is the deployed shape; the LAST constructed
# engine's ledger answers snapshot()/record_copy() so bench extras and
# flight dumps need no handle plumbing.
_current: Attribution | None = None
_current_lock = threading.Lock()


def set_current(attr: Attribution) -> None:
    global _current
    with _current_lock:
        _current = attr


def current() -> Attribution | None:
    return _current


def snapshot() -> dict[str, Any]:
    """The current ledger's snapshot, or the bare counters when no engine
    has registered one (CLI-only processes)."""
    attr = current()
    if attr is not None:
        return attr.snapshot()
    return {
        "dispatches": 0,
        "bytes_by_kind": {
            k: round(ATTR_BYTES.value(kind=k)) for k in _BYTE_KINDS
        },
    }


def record_copy(nbytes: float, direction: str, seconds: float | None = None) -> None:
    """Offload-tier page-copy attribution (the host KV tier's hook, for
    the slice that ports serving/offload/copy.py):
    device<->host page traffic rides the same HBM the decode stream uses,
    so it lands in the ledger as kind="other". Never raises."""
    try:
        ATTR_BYTES.inc(max(0.0, float(nbytes)), kind="other")
        ATTR_DISPATCHES.inc(op=f"offload_{direction}")
        if seconds is not None:
            ATTR_MEASURED_STEP_SECONDS.observe(
                seconds, op=f"offload_{direction}"
            )
        attr = current()
        if attr is not None:
            now = time.perf_counter()
            with attr._lock:
                attr._cum_bytes += float(nbytes)
                attr._window.append(
                    (now, attr._cum_flops, attr._cum_bytes)
                )
    except Exception:  # noqa: BLE001
        pass


def record_goodput(seconds: float, phase: str, slo_class: str = "") -> None:
    """Accumulate request wall seconds into the goodput split. Phases:
    queued / prefill / decode_active / tool_blocked. When the caller
    knows the request's SLO class the same seconds also land in the
    per-class split (opsagent_class_goodput_seconds_total), so "did
    goodput degrade by class during that burst?" is answerable. Never
    raises."""
    try:
        if seconds > 0:
            GOODPUT_SECONDS.inc(float(seconds), phase=phase)
            if slo_class:
                from . import CLASS_GOODPUT_SECONDS

                CLASS_GOODPUT_SECONDS.inc(
                    float(seconds), **{"class": slo_class, "phase": phase}
                )
    except Exception:  # noqa: BLE001
        pass
