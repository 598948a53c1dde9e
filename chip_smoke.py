#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``opsagent_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, each printing one JSON line with its seconds:

1. device: requires CUDA; reads the card's name and power limit.
2. build: compiles every kernel source in ``opsagent_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together; reports ptxas's registers
   and spills of the tensor-core instances (the bf16 ragged and decode
   kernels and the quantized matmul's m128 and m16 instances).
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 and f32. Paged attention, both forms (the "dma" kernels and the
   split-KV "grid" kernels; both forms' decode kernels split the KV
   sequence too, with a combine pass), over bf16/f32 pages and over int8
   pages at the widths of bench-8b (Llama-3-8B), Qwen2.5-7B (G = 7),
   bench-1b and tiny-test; the main path's bf16 shapes are timed: device
   times by CUDA graph replay (the kernels cycling over copies of the
   pages that pass ``ROTATE_BYTES``; SDPA over K/V gathered once), and
   the kernels' calls from Python beside them (``event_ms``); then (the
   ``matmul`` line) the quantized matmul, int8 and
   int4 with one whole-axis group and with groups of 128, at every
   bench-8b projection shape and Qwen2.5-7B's wk/wv and wg/wu with T in
   {1, 8, 128, 1024}, at aligned and unaligned edges (a ragged In, an int4
   group that straddles stages, an odd group) and at tiny-test widths.
   Errors for all; in bf16, device times (CUDA graph replay) of the mixed
   ticks' shapes (T = 128 and 1024) and of every served shape at a decode
   step (T = 8), each with its instance, its bound, cuBLAS's time and the
   time of the older instance on the same inputs (m64 at T > 16, r16 at
   T <= 16, with the m16 instance's split count), and the kernel's time
   through its Python wrapper, host included (``event_ms``).
4. e2e: 2-layer f32 cuts of bench-8b (dma kernels; unquantized, int8
   weights + int8 KV, int4 weights + int8 KV) and of Qwen2.5-7B (grid
   kernels; unquantized, int8 + int8 KV): ``Engine.generate`` through the
   kernels gives exactly the greedy tokens of the same engine through the
   plain versions, with a prefix-cache hit. Then (``e2e_bf16``) the same
   two cuts in bf16, bf16 pages and int8 KV: the first mixed step's
   last-position logits through the kernels against the plain path's.
5. hf: the HF-written fixtures ``tests/fixtures/tiny-{llama,qwen2,qwen3}-hf``
   loaded by the port's loader onto the card: last-position logits through
   the kernels within 2e-4 of HF's, and greedy tokens equal to HF's under
   both paged backends.
6. decode_graph: at full width and depth (bench-8b on the dma kernels in
   bf16 and with int8 weights + int8 KV, Qwen2.5-7B on the grid kernels in
   bf16), three engines over one model with one seed, two replaying the
   captured steps (CUDA graphs of the decode step and of each mixed
   bucket's forward + sample) and one running the same steps eagerly
   through the same kernels: four prompts admitted greedy through mixed
   ticks, with two more under the ReAct ToolPrompt schema (one row on the
   device FSM tables, one hosted behind a plain callable), and one greedy
   block give equal tokens, every cache byte and every launch counter's
   change equal, replayed and eager; the constrained rows' tokens are live
   DFA prefixes, the tables load once and the hosted row takes its own
   steps, equally in all three; the two replaying engines agree on
   everything, a sampled admission and block included.
7. serve: behind the HTTP server, random weights from ``--seed``, bf16
   activations, four concurrent chat completions per run: bench-8b at full
   depth on the dma kernels (unquantized, int8 weights + int8 KV, int4
   weights + int8 KV) and Qwen2.5-7B-Instruct at full depth on the grid
   kernels (unquantized, int8 weights + int8 KV), each engine warmed up
   (``warmup_s``) before the server starts. The kernels' launch
   counts of each run are checked and reported, and the quantized
   matmul's by instance: the m128 instance takes every projection of every
   mixed tick (7 x layers launches a tick), the m16 instance the rest
   (decode steps, the lm_head), and r16, m64 and f32 none. Every decode
   step and mixed tick must be a graph replay (``decode_replays`` =
   ``decode_steps``, ``mixed_replays`` = ``mixed_ticks``, no eager ones).
   The host's split, untraced: ``decode_steps`` (the sum of ``n_steps``
   over the ``decode_block`` calls) and ``mixed_ticks``, each with its
   host wall time per step or tick (``step_block`` and ``step_mixed``
   under ``time.perf_counter``), beside their device times by CUDA graph
   replay: ``decode_device_ms_per_step``, one decode step plus its argmax
   at the serve's shapes and page table, and ``mixed_device_ms_per_tick``,
   one tick at the largest bucket over the serve's last such tick's
   inputs. After the timed batch of each bf16 serve (bench-8b dma,
   Qwen2.5-7B grid), a ``constrained`` line: four more requests, untimed
   (two ToolPrompt json_schema completions, one streamed over SSE, one
   json_object, one unconstrained); each constrained reply is a live
   prefix of its DFA and parses when it stopped, every step replays, the
   ToolPrompt rows ride the device tables (loaded once) and only the
   json_object row (over the table budget) takes hosted steps; the line
   gives the table bytes, the load ms, the hosted steps and the decode
   step's device time with the rows at their FSM states and at row 0.
   The decode step timed includes the constraint mask and the FSM
   advance, as the step body runs them; ``decode_device_ms_alternated``
   times it with and without them, alternated, twice each.
   With ``--profile`` each run is traced with ``torch.profiler``
   and a ``profile`` line gives
   device time by kernel group, the quantized matmul split by instance
   and the combine of both attention forms' split calls as one group
   (the trace slows the run: its tokens/s and TTFT are not the untraced
   ones).

Then, on lines of their own: the card's name and power limit as nvidia-smi
prints them, the ``{"kernels": [...]}`` table, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
those lines.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from opsagent_tpu_torch.models.config import BENCH_8B, QWEN25_7B, config_from_hf, get_config_preset
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.models.loader import load_checkpoint
from opsagent_tpu_torch.models.quant import quantize_weight, quantize_weight4
from opsagent_tpu_torch.ops import cuda_build
from opsagent_tpu_torch.ops import paged_attention as pa
from opsagent_tpu_torch.ops import quant_matmul as qm
from opsagent_tpu_torch.ops.attention import QuantizedPages, _gather_kv, write_kv_pages
from opsagent_tpu_torch.serving import engine as engine_module
from opsagent_tpu_torch.serving.api import ServingStack, make_server
from opsagent_tpu_torch.serving.constrained import TOOLPROMPT_SCHEMA, json_constraint
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import NEG_INF, SamplingParams
from opsagent_tpu_torch.serving.tokenizer import ByteTokenizer

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# Timed kernels cycle over copies of their weights or pages that together
# pass twice the H100's L2: serving finds each layer's cold.
ROTATE_BYTES = 100e6
# Quantized matmul, as allclose(rtol=atol=tol) over outputs of unit scale:
# the JAX test's own 1e-3 in f32; 1e-2 in bf16, where one ulp of the bf16
# output is up to 2^-7 relative.
MM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
PAGED = "opsagent_tpu/ops/paged_attention_pallas.py"
KERNELS = {  # name: (source in csrc/, the TPU kernel it replaces)
    "paged_ragged_attention": ("paged_attention.cu", f"{PAGED}:830"),
    "paged_decode_attention": ("paged_attention.cu", f"{PAGED}:310"),
    # The QuantizedPages branches of the same two kernels.
    "paged_ragged_attention_int8": ("paged_attention.cu", f"{PAGED}:895"),
    "paged_decode_attention_int8": ("paged_attention.cu", f"{PAGED}:373"),
    "quant_matmul_int8": ("quant_matmul.cu", "opsagent_tpu/ops/quant_matmul_pallas.py:51"),
    "quant_matmul_int4": ("quant_matmul.cu", "opsagent_tpu/ops/quant_matmul_pallas.py:117"),
    # The grid forms and their QuantizedPages operands.
    "paged_ragged_attention_grid": ("paged_attention_grid.cu", f"{PAGED}:571"),
    "paged_decode_attention_grid": ("paged_attention_grid.cu", f"{PAGED}:957"),
    "paged_ragged_attention_grid_int8": ("paged_attention_grid.cu", f"{PAGED}:629"),
    "paged_decode_attention_grid_int8": ("paged_attention_grid.cu", f"{PAGED}:1006"),
}
# (model, paged backend, quantize, kv_quantize) of each serve run.
SERVES = (
    ("bench-8b", "dma", "", ""),
    ("bench-8b", "dma", "int8", "int8"),
    ("bench-8b", "dma", "int4", "int8"),
    ("qwen2.5-7b-instruct", "grid", "", ""),
    ("qwen2.5-7b-instruct", "grid", "int8", "int8"),
)
# (2-layer cut, paged backend, quantize, kv_quantize) of each e2e check.
E2E = (
    (BENCH_8B, "dma", "", ""),
    (BENCH_8B, "dma", "int8", "int8"),
    (BENCH_8B, "dma", "int4", "int8"),
    (QWEN25_7B, "grid", "", ""),
    (QWEN25_7B, "grid", "int8", "int8"),
)
# (2-layer cut, paged backend) of each bf16 logits check, each with bf16
# pages and with int8 KV; the q_lens of its first mixed step, all rows
# from position 0.
E2E_BF16 = ((BENCH_8B, "dma"), (QWEN25_7B, "grid"))
E2E_BF16_Q_LENS = [128, 128, 77, 1, 33, 0, 128, 5]
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
HF_FIXTURES = ("tiny-llama-hf", "tiny-qwen2-hf", "tiny-qwen3-hf")
HF_LOGIT_TOL = 2e-4     # tests/test_checkpoint_golden.py's own


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after a warm-up call. ``fn`` takes the call's index."""
    fn(0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``calls`` calls of ``fn`` (which takes the
    call's index) captured into a CUDA graph after two warm-up calls, then
    replayed ``replays`` times between CUDA events. Unlike ``time_ms`` it
    leaves out the host's time per call, which at a decode step's shapes
    exceeds the kernel's."""
    fn(0)
    fn(1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    t1.synchronize()
    del graph
    return t0.elapsed_time(t1) / (calls * replays)


def reset_launch_counts() -> None:
    pa.reset_launch_counts()
    qm.reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {**pa.LAUNCHES, **qm.LAUNCHES}


# -- phase 2: build ---------------------------------------------------------------
def demangle(names: list[str]) -> list[str]:
    """C++ names through the toolkit's cu++filt (or c++filt); the mangled
    names where neither is there."""
    nvcc_dir = os.path.dirname(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc")
    for tool in (os.path.join(nvcc_dir, "cu++filt"), shutil.which("c++filt")):
        if tool and os.path.exists(tool):
            res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                                 text=True, timeout=60)
            out = res.stdout.splitlines()
            if res.returncode == 0 and len(out) == len(names):
                return out
    return names


def ptxas_report(log: str) -> list[dict]:
    """Registers and spills of every kernel in ptxas's ``-v`` report."""
    rows: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line):
            name = m.group(1)
            rows.setdefault(name, {"kernel": name})
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rows[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            rows[name]["registers"] = int(m.group(1))
    out = [r for r in rows.values() if "registers" in r]
    for r, full in zip(out, demangle([r["kernel"] for r in out])):
        # "void <unnamed>::ragged_kernel<__nv_bfloat16, signed char, (int)128,
        # (int)16>(...)" -> "ragged_kernel<__nv_bfloat16, signed char, 128, 16>"
        full = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\(int\)|^void ", "", full)
        r["kernel"] = full.split(">(")[0] + ">" if ">(" in full else full
    return out


def phase_build() -> dict:
    """One nvcc per source, all started together; ptxas's reports go to
    stderr, and the registers and spills of the tensor-core instances (the
    bf16 ragged and decode kernels of both forms, the quantized matmul's
    m128 and m16 instances) into the phase line."""
    sources = sorted({src for src, _ in KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda s: cuda_build.build(s, verbose=True), sources))
    tensor_core, decode, m128, m16 = [], [], [], []
    for _, log in built:
        print(log, file=sys.stderr)
        report = ptxas_report(log)
        tensor_core += [r for r in report
                        if "ragged" in r["kernel"] and "bfloat16" in r["kernel"]
                        and "decode" not in r["kernel"]]
        decode += [r for r in report
                   if "decode" in r["kernel"] and "bfloat16" in r["kernel"]]
        m128 += [r for r in report if "qmm_m128_kernel" in r["kernel"]]
        m16 += [r for r in report if "qmm_m16_kernel" in r["kernel"]]
    check(len(tensor_core) >= 16,
          f"ptxas reported {len(tensor_core)} bf16 ragged instances, expected 16")
    check(len(decode) == 16,
          f"ptxas reported {len(decode)} bf16 decode instances, expected 16")
    check(len(m128) == 4, f"ptxas reported {len(m128)} m128 matmul instances, expected 4")
    check(len(m16) == 4, f"ptxas reported {len(m16)} m16 matmul instances, expected 4")
    return {"libraries": [lib.name for lib, _ in built], "ptxas_tensor_core": tensor_core,
            "ptxas_decode": decode, "ptxas_quant_matmul_m128": m128,
            "ptxas_quant_matmul_m16": m16}


# -- phase 3: attention kernels against their plain versions -------------------
def make_case(gen, B, S, H, K, D, P, starts, q_lens, dtype):
    """Random paged inputs: each row owns cdiv(start + q_len, P) pages in
    random order, then two -1 slots past its pages."""
    ctx = [s + q for s, q in zip(starts, q_lens)]
    owned = [math.ceil(c / P) for c in ctx]
    max_pages = max(owned) + 2
    N = sum(owned) + 3
    perm = torch.randperm(N, generator=gen, device="cuda").to(torch.int32)
    table = torch.full((B, max_pages), -1, dtype=torch.int32, device="cuda")
    at = 0
    for b, n in enumerate(owned):
        table[b, :n] = perm[at:at + n]
        at += n

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return dict(
        q=randn(B, S, H, D), k=randn(N, P, K, D), v=randn(N, P, K, D),
        table=table,
        start=torch.tensor(starts, dtype=torch.int32, device="cuda"),
        q_lens=torch.tensor(q_lens, dtype=torch.int32, device="cuda"),
    )


def quantize_case(c):
    """The case with int8 pages: each row's visible K/V rows, read out of
    its pages, written through the plain quantized write path."""
    k, v, table = c["k"], c["v"], c["table"]
    N, P, K, D = k.shape
    ctx = (c["start"] + c["q_lens"]).int()
    slot = torch.arange(max(int(ctx.max()), 1), device="cuda")
    page = table.long().clamp(min=0)[:, (slot // P).clamp(max=table.shape[1] - 1)]
    qk, qv = (QuantizedPages(torch.zeros(N, P, K, D, dtype=torch.int8, device="cuda"),
                             torch.ones(N, P, K, device="cuda")) for _ in range(2))
    write_kv_pages(qk, qv, k[page, slot % P], v[page, slot % P], table,
                   torch.zeros_like(ctx), valid_len=ctx)
    return {**c, "k": qk, "v": qv}


def attention_bound_ms(c, int_arrays: int) -> tuple[float, str]:
    """Least time for this input (ragged ``[B, S, H, D]`` or decode
    ``[B, H, D]`` q). Bytes, each once: the K/V rows each sequence can see,
    the table entries of the pages that hold them, the valid query rows
    (a padding row's output is zeros whatever q holds there), the
    ``int_arrays`` int32 ``[B]`` inputs the kernel reads, and the whole
    output written. An int8 K or V row costs D + 4 bytes (its codes and
    its f32 scale). Operations: 4 * D per (query head, valid query row,
    position it sees)."""
    q, k = c["q"], c["k"]
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    P, K = k.shape[1], k.shape[2]
    row_bytes = D + 4 if isinstance(k, QuantizedPages) else D * k.element_size()
    cap = c["table"].shape[1] * P
    rows = list(zip(c["start"].tolist(), c["q_lens"].tolist()))
    visible = [min(s + n, cap) if n > 0 else 0 for s, n in rows]
    elt = q.element_size()
    nbytes = (
        sum(n for _, n in rows) * H * D * elt
        + q.numel() * elt
        + 2 * sum(visible) * K * row_bytes
        + sum(math.ceil(v / P) for v in visible) * 4
        + int_arrays * B * 4
    )
    ops = 4 * H * D * sum(min(s + i + 1, cap) for s, n in rows for i in range(n))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ragged_sdpa(c):
    """The PyTorch yardstick: scaled_dot_product_attention over K/V that
    are already gathered (int8 pages: dequantized to q's dtype) and
    expanded to the query heads, with the ragged causal mask (fully masked
    rows come out NaN: timing only)."""
    q = c["q"]
    B, S, H, D = q.shape
    k_seq, v_seq = _gather_kv(c["k"], c["v"], c["table"], None, q.dtype)
    G = H // k_seq.shape[2]
    kh = k_seq.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v_seq.transpose(1, 2).repeat_interleave(G, dim=1)
    T = k_seq.shape[1]
    t = torch.arange(T, device="cuda")[None, None, :]
    qpos = c["start"].long()[:, None, None] + torch.arange(S, device="cuda")[None, :, None]
    end = (c["start"] + c["q_lens"]).long()[:, None, None]
    mask = ((t <= qpos) & (t < end))[:, None]
    qh = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def wrapper(name):
    """The wrapper of a kernel row: ragged or decode, dma or grid form."""
    ragged, decode = pa.PAGED_BACKENDS["grid" if "_grid" in name else "dma"]
    return ragged if name.startswith("paged_ragged") else decode


def kernel_args(name, c):
    if name.startswith("paged_ragged"):
        return (c["q"], c["k"], c["v"], c["table"], c["start"], c["q_lens"])
    return (c["q"], c["k"], c["v"], c["table"], c["lengths"])


def page_copies(c) -> list[tuple]:
    """The case's (k, v) pages and copies of them that together pass
    ``ROTATE_BYTES``: a serve reads each layer's pages cold, and the
    timed decode case's pages alone fit in the L2."""
    def nbytes(t):
        return (t.q.numel() + t.scale.numel() * 4 if isinstance(t, QuantizedPages)
                else t.numel() * t.element_size())

    def clone(t):
        return (QuantizedPages(t.q.clone(), t.scale.clone())
                if isinstance(t, QuantizedPages) else t.clone())

    n = math.ceil(ROTATE_BYTES / (nbytes(c["k"]) + nbytes(c["v"])))
    return [(c["k"], c["v"])] + [(clone(c["k"]), clone(c["v"])) for _ in range(n - 1)]


def run_kernel_case(name, c, dtype, timed):
    fn, args = wrapper(name), kernel_args(name, c)
    got = fn(*args)
    want = fn(*args, plain=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= TOL[dtype],
          f"{name} {tuple(c['q'].shape)} {dtype}: max err {err} > {TOL[dtype]}")
    out = {"max_abs_err": err}
    if timed:
        # Device times by graph replay, each call on the next copy of the
        # pages; event_ms is the same calls from Python, host included.
        copies = page_copies(c)

        def call(f):
            return lambda i: f(args[0], *copies[i % len(copies)], *args[3:])

        sdpa = c["sdpa"]
        out["ms"] = graph_ms(call(fn))
        out["event_ms"] = time_ms(call(fn))
        out["plain_ms"] = time_ms(lambda i: fn(*args, plain=True), iters=3)
        out["library_ms"] = graph_ms(lambda i: sdpa())
        out["bound_ms"], out["bound_by"] = c["bound"]
        if "_grid" in name:
            # The dma form of the same function on the same inputs.
            out["dma_ms"] = graph_ms(call(wrapper(name.replace("_grid", ""))))
        del copies
    return out


def decode_case(gen, B, H, K, D, P, lengths, dtype):
    """Decode inputs as a ragged case with one query per row: lengths
    include the new token, so start = length - 1 and q_len = 1 (0 for an
    empty row). The last row's second page slot is -1 (read as page 0)."""
    c = make_case(
        gen, B, 1, H, K, D, P, [max(n - 1, 0) for n in lengths],
        [1 if n else 0 for n in lengths], dtype,
    )
    c["lengths"] = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    c["q"] = c["q"][:, 0]
    c["table"][-1, 1] = -1
    return c


def phase_kernels(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # Rows: decode rows (q_len 1) beside prefill chunks, a row that starts
    # mid-page, a q_len 0 row, contexts from 1 to 4096.
    ragged_rows = {
        16: ([4095, 0, 5, 1000, 3001, 4080, 0, 17], [1, 16, 0, 1, 13, 16, 1, 9]),
        128: ([3968, 0, 5, 1000, 3001, 0, 200, 17], [128, 128, 0, 1, 77, 1, 128, 33]),
    }
    decode_lengths = [1, 17, 300, 1024, 2049, 4096, 0, 77]
    widths = [  # (name, H, K, D, P)
        ("bench-8b", 32, 8, 128, 16),
        ("qwen2.5-7b", 28, 4, 128, 16),
        ("bench-1b", 32, 8, 64, 16),
        ("tiny-test", 4, 2, 16, 4),
    ]
    # Each form is timed at the widths of the serve path it runs on.
    timed_width = {"dma": "bench-8b", "grid": "qwen2.5-7b"}
    results: dict[str, dict] = {}
    cases = []

    def attend(base, c, dtype, wname, int_arrays, full, **where):
        """The case through both forms of the kernel, then, with its pages
        quantized, through their int8 instances; times the main path's
        shapes (``full``: the main path's shape at bf16)."""
        for suffix, case in (("", c), ("_int8", quantize_case(c))):
            for form in ("dma", "grid"):
                name = base + ("_grid" if form == "grid" else "") + suffix
                timed = full and dtype == torch.bfloat16 and wname == timed_width[form]
                if timed:
                    q = case["q"] if case["q"].ndim == 4 else case["q"][:, None]
                    case["bound"] = attention_bound_ms(case, int_arrays)
                    case["sdpa"] = ragged_sdpa({**case, "q": q})
                r = run_kernel_case(name, case, dtype, timed)
                cases.append(dict(kernel=name, width=wname, **where, dtype=str(dtype)[6:],
                                  err=r["max_abs_err"], tol=TOL[dtype]))
                if timed:
                    results[name] = r
            case.pop("sdpa", None)

    for dtype in (torch.bfloat16, torch.float32):
        for wname, H, K, D, P in widths:
            for S, (starts, lens) in ragged_rows.items():
                if wname not in timed_width.values() and S != 16:
                    continue
                c = make_case(gen, 8, S, H, K, D, P, starts, lens, dtype)
                # S = 128 is the main path's prefill chunk shape; the
                # kernels read start and q_lens.
                attend("paged_ragged_attention", c, dtype, wname, 2, S == 128, S=S)
                del c
            c = decode_case(gen, 8, H, K, D, P, decode_lengths, dtype)
            attend("paged_decode_attention", c, dtype, wname, 1, True)  # lengths
            del c
    emit({"phase": "kernels_cases", "cases": cases})
    return results


# -- phase 3: the quantized matmul against its plain version -------------------
MM_SHAPES = {  # the served projections: (In, Out)
    "wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "wg/wu": (4096, 14336),
    "wd": (14336, 4096), "lm_head": (4096, 128256),
    "qwen wk/wv": (3584, 512), "qwen wg/wu": (3584, 18944),
}
# Edges: a ragged In (the m64 and r16 instances), an int4 group of 80 that
# the staged instances' 64-row stages straddle with a column edge inside a
# block, an odd int4 group of 67 (m64, r16), and tiny-test's widths.
MM_EXTRA = {"ragged In": (300, 520), "uneven group": (320, 528), "odd group": (536, 256),
            "tiny wq": (64, 64), "tiny wg": (64, 128), "tiny wd": (128, 64),
            "tiny lm_head": (64, 512)}
MM_MODES = (("int8", 8, 0), ("int4 G=1", 4, 0), ("int4 g128", 4, 128))
# Timed bf16 (shape, T): the mixed ticks' projections (T = 8 x bucket, 128
# to 1024), and every served shape at a decode step (T = 8); wg/wu's is
# the kernel table's row.
MM_TIMED = ({(s, T) for s in ("wq/wo", "wk/wv", "wg/wu", "wd") for T in (128, 1024)}
            | {("qwen wk/wv", 1024), ("qwen wg/wu", 1024)}
            | {(s, 8) for s in MM_SHAPES})


def quantized_weight(gen, In, Out, bits, group):
    w = torch.randn(In, Out, generator=gen, device="cuda")
    return quantize_weight(w) if bits == 8 else quantize_weight4(w, group=group)


def matmul_bound_ms(x, w) -> tuple[float, str]:
    """Bytes, each once: the codes, the scales, x and y. Operations:
    2 * T * In * Out."""
    T, In = x.shape
    Out = w.shape[1]
    nbytes = (w.q.numel() + w.scale.numel() * 4
              + (T * In + T * Out) * x.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * T * In * Out / PEAK_OPS[x.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_matmul(gen, w, x, bits, group) -> dict:
    """Kernel, plain version, and cuBLAS over the weight already
    dequantized to x's dtype; also the older instance on the same inputs
    (m64 at T > 16, r16 at T <= 16, beside the m16 instance's splits).
    The kernels and cuBLAS each cycle over copies of the weight that
    together pass ``ROTATE_BYTES``. Their times are device times
    (``graph_ms``); ``event_ms`` is the kernel's calls from Python, host
    included."""
    In, Out = w.shape
    T = x.shape[0]
    n = math.ceil(ROTATE_BYTES / w.q.numel())
    copies = [w] + [quantized_weight(gen, In, Out, bits, group) for _ in range(n - 1)]
    dense = [c.dequantize().to(x.dtype)
             for c in copies[:math.ceil(ROTATE_BYTES / (In * Out * x.element_size()))]]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instance, block_n = qm.plan(T, In, Out, bits, qm._group(w), x.dtype, sms)
    out = {"T": T, "In": In, "Out": Out, "instance": instance, "block_n": block_n}
    out["ms"] = graph_ms(lambda i: qm.quant_matmul_cuda(x, copies[i % len(copies)]))
    out["event_ms"] = time_ms(lambda i: qm.quant_matmul_cuda(x, copies[i % len(copies)]))
    out["plain_ms"] = time_ms(lambda i: qm.quant_matmul_cuda(x, w, plain=True), iters=3)
    out["library_ms"] = graph_ms(lambda i: x @ dense[i % len(dense)])
    if T > 16:
        out["m64_ms"] = graph_ms(lambda i: qm._launch(x, copies[i % len(copies)], "m64", 64))
    else:
        out["splits"] = qm.split_k(T, In, Out, block_n, sms) if instance == "m16" else 1
        out["r16_ms"] = graph_ms(lambda i: qm._launch(x, copies[i % len(copies)], "r16", 64))
    out["bound_ms"], out["bound_by"] = matmul_bound_ms(x, w)
    del copies, dense
    return out


def phase_matmul(seed: int) -> tuple[list[dict], dict]:
    """Every case against the plain version; returns the timed rows, and
    the kernel table's row of each weight width (wg/wu, T = 8, int8 and
    int4 with one whole-axis group, the serve phase's weights)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    timed, rows = [], {}
    cases = []
    for label, (In, Out) in {**MM_SHAPES, **MM_EXTRA}.items():
        tiny = label in MM_EXTRA
        for mode, bits, group in MM_MODES:
            w = quantized_weight(gen, In, Out, bits, group)
            name = f"quant_matmul_int{bits}"
            # Inputs scaled so that the outputs have unit scale.
            col = w.dequantize().norm(dim=0).mean().item()
            for dtype in (torch.bfloat16, torch.float32):
                for T in ((1, 8, 96) if tiny else (1, 8, 128, 1024)):
                    x = (torch.randn(T, In, generator=gen, device="cuda") / col).to(dtype)
                    got = qm.quant_matmul_cuda(x, w)
                    want = qm.quant_matmul_cuda(x, w, plain=True)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs()
                    tol = MM_TOL[dtype]
                    ok = bool((err <= tol + tol * want.float().abs()).all())
                    check(ok and got.dtype == dtype,
                          f"{name} {mode} T={T} [{In}, {Out}] {dtype}: "
                          f"max err {err.max().item()} beyond rtol=atol={tol}")
                    cases.append(dict(kernel=name, mode=mode, shape=label, T=T,
                                      dtype=str(dtype)[6:],
                                      err=err.max().item(), tol=tol))
                    if dtype == torch.bfloat16 and (label, T) in MM_TIMED:
                        r = {"kernel": name, "mode": mode, "shape": label,
                             **time_matmul(gen, w, x, bits, group),
                             "max_abs_err": err.max().item()}
                        timed.append(r)
                        if label == "wg/wu" and T == 8 and mode != "int4 g128":
                            rows[name] = r
                    del x, got, want, err
            del w
    emit({"phase": "matmul_cases", "cases": cases})
    return timed, rows


# -- phase 4: end-to-end equality through kernels and plain versions -----------
def phase_e2e(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    p0 = [257] + torch.randint(0, 256, (299,), generator=gen).tolist()
    p1 = [257] + torch.randint(0, 256, (199,), generator=gen).tolist()
    p2 = p0[:100] + torch.randint(0, 256, (60,), generator=gen).tolist()
    greedy = SamplingParams(max_tokens=16)
    report = {}
    for base, backend, quantize, kv_quantize in E2E:
        cfg = replace(base, name=f"{base.name}-2l", num_layers=2)
        model = Llama(cfg, torch.float32, "cuda", seed=seed, quantize=quantize)
        out = {}
        for impl in ("cuda", "plain"):
            eng = Engine(
                EngineConfig(model=cfg.name, dtype=torch.float32, device="cuda",
                             attn_impl=impl, seed=seed, num_pages=256,
                             quantize=quantize, kv_quantize=kv_quantize,
                             paged_backend=backend),
                model_cfg=cfg, model=model,
            )
            # p2 is admitted after p0 finished and donated its pages: a hit.
            toks = eng.generate([p0, p1], greedy) + eng.generate([p2], greedy)
            out[impl] = (toks, eng.alloc.hit_tokens)
            del eng
        del model
        torch.cuda.empty_cache()
        label = (f"{cfg.name} {backend}, weights {quantize or 'f32'}, "
                 f"kv {kv_quantize or 'f32'}")
        (tk, hk), (tp, hp) = out["cuda"], out["plain"]
        check(all(len(t) == 16 for t in tk), f"{label}: kernel path lengths {[len(t) for t in tk]}")
        check(tk == tp, f"{label}: kernel-path tokens {tk} != plain-path tokens {tp}")
        check(hk > 0 and hp == hk, f"{label}: prefix hits {hk} / {hp}")
        report[label] = {"tokens_equal": True, "prefix_hit_tokens": hk, "tokens": tk}
    return report


def phase_e2e_bf16(seed: int) -> dict:
    """The first mixed step of eight fresh prompts (``E2E_BF16_Q_LENS``,
    S = 128) through a 2-layer bf16 cut, on each backend's kernels (the
    tensor-core ragged instances) and on the plain path: the last-position
    logits of every row with a prompt, with bf16 pages and with int8 KV.
    Tolerance: the kernel path may differ from the plain path by no more
    than the plain path differs from the same weights computed in f32,
    the cost of bf16 itself; the kernels agree with their plain versions
    to a bf16 ulp of the attention output, far inside it. Greedy-token
    agreement is reported, not checked: a near-tie may flip."""
    gen = torch.Generator().manual_seed(seed)
    B, S, P = len(E2E_BF16_Q_LENS), 128, 16
    pages = S // P
    table = torch.arange(B * pages, dtype=torch.int32, device="cuda").reshape(B, pages)
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    q_lens = torch.tensor(E2E_BF16_Q_LENS, dtype=torch.int32, device="cuda")
    valid = q_lens > 0
    report = {}
    for base, backend in E2E_BF16:
        cfg = replace(base, name=f"{base.name}-2l", num_layers=2)
        model = Llama(cfg, torch.bfloat16, "cuda", seed=seed)
        ref = Llama(cfg, torch.float32, "cuda", seed=None)
        ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in model.state_dict().items()})
        tokens = torch.randint(0, 256, (B, S), generator=gen).to("cuda")
        for kv_quantize in ("", "int8"):
            def last_logits(m, plain):
                cache = m.make_cache(B * pages, P, kv_quantize)
                with torch.inference_mode():
                    return m.mixed_step(tokens, start, q_lens, cache, table,
                                        plain=plain, backend=backend)[valid]
            name = ("paged_ragged_attention" + ("_grid" if backend == "grid" else "")
                    + ("_int8" if kv_quantize else ""))
            before = pa.LAUNCHES[name]
            got = last_logits(model, False)
            launched = pa.LAUNCHES[name] - before
            want = last_logits(model, True)
            f32 = last_logits(ref, True)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            bf16_err = (want - f32).abs().max().item()
            label = f"{cfg.name} {backend}, kv {kv_quantize or 'bf16'}"
            check(launched == cfg.num_layers, f"{label}: {name} launched {launched} times")
            check(math.isfinite(err) and err <= bf16_err,
                  f"{label}: kernel-path logits off the plain path's by {err}, "
                  f"more than bf16 costs against f32 ({bf16_err})")
            report[label] = {
                "max_abs_err": err, "plain_vs_f32_max_abs_err": bf16_err,
                "max_abs_logit": want.abs().max().item(),
                "greedy_agree": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
            }
            del got, want, f32
        del model, ref
        torch.cuda.empty_cache()
    return report


# -- phase 5: HF checkpoints against HF's own outputs ----------------------------
def phase_hf() -> dict:
    """Each fixture loaded by the port's loader onto the card: its prompt
    as one mixed step through each backend's kernels gives HF's last
    logits, and the engine (``--model-name auto``) HF's greedy tokens."""
    report = {}
    for name in HF_FIXTURES:
        path = os.path.join(FIXTURES, name)
        golden = np.load(os.path.join(path, "golden.npz"))
        prompt, want = golden["prompt"].tolist(), golden["greedy"].tolist()
        cfg = config_from_hf(path)
        model = Llama(cfg, torch.float32, "cuda", seed=None)
        model.load_state_dict(load_checkpoint(path, cfg, torch.float32, "cuda"))
        last = torch.from_numpy(golden["last_logits"]).to("cuda")
        row = {}
        for backend in ("dma", "grid"):
            cache = model.make_cache(16, 4)
            with torch.inference_mode():
                logits = model.mixed_step(
                    torch.tensor([prompt], device="cuda"),
                    torch.zeros(1, dtype=torch.int32, device="cuda"),
                    torch.tensor([len(prompt)], dtype=torch.int32, device="cuda"),
                    cache, torch.arange(16, dtype=torch.int32, device="cuda")[None],
                    backend=backend,
                )[0]
            err = (logits - last).abs().max().item()
            check(err <= HF_LOGIT_TOL, f"{name} {backend}: last logits off by {err}")
            eng = Engine(EngineConfig(
                model="auto", checkpoint=path, dtype=torch.float32, device="cuda",
                page_size=4, num_pages=64, max_pages_per_seq=16, max_batch_size=2,
                paged_backend=backend,
            ))
            got = eng.generate([prompt], SamplingParams(max_tokens=len(want)))[0]
            check(got == want, f"{name} {backend}: greedy {got} != HF's {want}")
            row[backend] = {"last_logits_max_err": err, "greedy_equal": True}
            del eng
        report[name] = row
    return report


# -- phase 6: the decode graph against the eager step -----------------------------
# (model, paged backend, quantize, kv_quantize) of each replay-vs-eager check.
DECODE_GRAPH = (
    ("bench-8b", "dma", "", ""),
    ("bench-8b", "dma", "int8", "int8"),
    ("qwen2.5-7b-instruct", "grid", "", ""),
)


def cache_bytes(cache) -> list[torch.Tensor]:
    """The cache's pages (and int8 scales), the scratch slot left out."""
    sides = (cache.k, cache.v)
    return [t for s in sides for t in ((s.q, s.scale) if cache.quantized else (s,))]


def routes(eng: Engine) -> tuple[int, int, int, int]:
    """(decode steps replayed, decode steps run eagerly, mixed ticks
    replayed, mixed ticks run eagerly) so far."""
    return eng.decode_replays, eng.decode_eager_steps, eng.mixed_replays, eng.mixed_eager_ticks


def graph_run(eng: Engine, prompts: list[list[int]], constrained: list[list[int]]) -> dict:
    """The phase's script on one engine: warm up; admit the prompts
    (greedy) through mixed steps, and the ``constrained`` ones under the
    ToolPrompt schema, the first on the device tables and the second
    hosted (behind a plain callable); one greedy block (the hosted row
    takes one step of its own in it); then two of the prompts again,
    sampled (temperature 0.8, top-p 0.9), admitted beside the running
    rows, and one block, sampled. Returns what each part left: tokens,
    cache bytes (copies), launch counters' changes, routes."""
    def counters():
        return launch_counts() | dict(qm.INSTANCE_LAUNCHES)

    def part(fn):
        before = counters()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = counters()
        return {"out": out, "wall_ms": wall * 1e3,
                "cache": [t.clone() for t in cache_bytes(eng.cache)],
                "launches": {k: n - before[k] for k, n in after.items() if n != before[k]}}

    greedy = SamplingParams(max_tokens=64)
    sampled = SamplingParams(temperature=0.8, top_p=0.9, max_tokens=64)
    device_row, hosted = (json_constraint(eng.tokenizer, TOOLPROMPT_SCHEMA) for _ in range(2))
    masks = [None] * len(prompts) + [device_row, lambda toks: hosted(toks)]
    warm = eng.warmup()
    admit = part(lambda: [eng.add_request(p, greedy, m)
                          for p, m in zip(prompts + constrained, masks)])
    ids = admit["out"]
    admit["out"] = [eng.sequences[i].tokens[:] for i in ids]
    block = part(lambda: eng.step_block(ids))
    mixed = part(lambda: [eng.add_request(p, sampled) for p in prompts[:2]])
    mixed["out"] = [eng.sequences[i].tokens[:] for i in mixed["out"]]
    block_sampled = part(lambda: eng.step_block())
    dfa = device_row.fsm.dfa
    live = all(dfa.run(dfa.start, bytes(t for t in eng.sequences[i].tokens
                                          if t != eng.tokenizer.eos_id)) >= 0
               for i in ids[-2:])
    return {"warmup_s": warm, "admit": admit, "block": block,
            "admit_sampled": mixed, "block_sampled": block_sampled,
            "routes": routes(eng), "hosted_steps": eng.hosted_steps,
            "fsm_loads": eng.fsm_loads, "constrained_live": live}


def phase_decode_graph(seed: int) -> dict:
    """At full width and depth, one model and three engines over it, the
    same seed: two replay the captured steps (``cuda_graphs``), the third
    runs them eagerly through the same kernels; each runs ``graph_run``.
    Replayed against eager: the greedy admission (mixed ticks) and the
    greedy block give equal tokens, every cache byte and every launch
    counter's change equal. The two replaying engines agree on everything,
    the sampled admission and block included: a sampled replay is held to
    determinism, not to the eager path's draws (reported, not checked)."""
    gen = torch.Generator().manual_seed(seed)
    report = {}
    for name, backend, quantize, kv_quantize in DECODE_GRAPH:
        cfg = get_config_preset(name)
        model = Llama(cfg, torch.bfloat16, "cuda", seed=seed, quantize=quantize)
        prompts = [[257] + torch.randint(0, 256, (n,), generator=gen).tolist()
                   for n in (300, 800, 1500, 3000, 200, 500)]
        # One tokenizer: the engines share its cached ToolPrompt FSM.
        tokenizer = ByteTokenizer(cfg.vocab_size)
        runs = []
        for replay in (True, True, False):
            eng = Engine(EngineConfig(model=name, dtype=torch.bfloat16, device="cuda",
                                      seed=seed, num_pages=512, quantize=quantize,
                                      kv_quantize=kv_quantize, paged_backend=backend,
                                      cuda_graphs=replay),
                         model_cfg=cfg, model=model, tokenizer=tokenizer)
            runs.append(graph_run(eng, prompts[:4], prompts[4:]))
            del eng
        label = f"{name} {backend}, weights {quantize or 'bf16'}, kv {kv_quantize or 'bf16'}"
        g, g2, e = runs
        replays, eager = g["routes"], e["routes"]
        check(replays[0] > 0 and replays[2] > 0 and replays[1] == replays[3] == 0
              and eager[1] > 0 and eager[3] > 0 and eager[0] == eager[2] == 0,
              f"{label}: routes (decode replays, eager steps, mixed replays, eager "
              f"ticks) {replays} replayed, {eager} eager")

        def same(a, b, parts):
            return all(a[p]["out"] == b[p]["out"] and a[p]["launches"] == b[p]["launches"]
                       and all(torch.equal(x, y) for x, y in zip(a[p]["cache"], b[p]["cache"]))
                       for p in parts)

        greedy_parts = ("admit", "block")
        every_part = greedy_parts + ("admit_sampled", "block_sampled")
        check(same(g, e, greedy_parts),
              f"{label}: replayed greedy admission or block differs from the eager one "
              f"(tokens {g['block']['out']} / {e['block']['out']})")
        check(same(g, g2, every_part), f"{label}: two replaying engines differ")
        check(g["routes"] == g2["routes"], f"{label}: routes {g['routes']} / {g2['routes']}")
        for run in runs:
            check(run["constrained_live"] and run["fsm_loads"] == 1 and run["hosted_steps"] > 0
                  and run["hosted_steps"] == g["hosted_steps"],
                  f"{label}: constrained rows: live {run['constrained_live']}, "
                  f"{run['fsm_loads']} table loads, {run['hosted_steps']} hosted steps")
        report[label] = {
            "greedy_equal_to_eager": True, "deterministic": True,
            "hosted_steps": g["hosted_steps"], "constrained_live": True,
            "sampled_equal_to_eager": same(g, e, every_part),
            "routes_replayed": g["routes"], "routes_eager": e["routes"],
            "block_launches": g["block"]["launches"],
            "wall_ms": {p: {"replay": g[p]["wall_ms"], "eager": e[p]["wall_ms"]}
                        for p in every_part},
            "warmup_s": {"replay": g["warmup_s"], "eager": e["warmup_s"]},
        }
        del runs, g, g2, e, model
        gc.collect()
        torch.cuda.empty_cache()
    return report


# -- phase 7: serving at full width -------------------------------------------
KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names, spaces and "(int)" removed)
    ("paged_ragged_attention", ("ragged_kernel",)),
    ("paged_decode_attention", ("decode_kernel",)),
    ("paged_ragged_attention_grid", ("ragged_split_kernel",)),
    ("paged_decode_attention_grid", ("decode_split_kernel",)),
    ("paged_attention_combine", ("combine_kernel",)),   # both forms' split calls
    # The quantized matmul by instance: m128 runs the mixed ticks'
    # projections, m16 the decode steps' and every lm_head.
    ("quant_matmul_m128", ("qmm_m128_kernel",)),
    ("quant_matmul_m16", ("qmm_m16_kernel",)),
    ("quant_matmul", ("qmm_",)),
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")),
)


def device_time_by_group(prof) -> dict:
    """Self device time (ms) of every kernel in the trace, by group."""
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us <= 0:
            continue
        name = re.sub(r"\(int\)|\s", "", evt.key.lower())
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        out[group] = out.get(group, 0.0) + us / 1e3
    return out


def expected_kernels(backend: str, quantize: str, kv_quantize: str) -> set[str]:
    """The kernels a serve run of this configuration must launch; it must
    launch no other."""
    form = "_grid" if backend == "grid" else ""
    suffix = "_int8" if kv_quantize else ""
    names = {f"paged_ragged_attention{form}{suffix}", f"paged_decode_attention{form}{suffix}"}
    if quantize:
        names.add(f"quant_matmul_{quantize}")
    return names


class TickClock:
    """Host wall time of the engine's ticks: the engine instance's
    ``step_block`` and ``step_mixed`` wrapped with ``time.perf_counter``
    (both return with their device work done and their tokens on the
    host), decode steps counted through the engine module's
    ``decode_block`` calls (the sum of ``n_steps``), and mixed ticks as the
    ``step_mixed`` calls that ran a forward. Keeps the arguments of the
    block with the most active rows, for ``decode_device_ms``."""

    def __init__(self, engine: Engine):
        self.reset()
        self._decode_block = engine_module.decode_block
        step_block, step_mixed = engine.step_block, engine.step_mixed

        def timed_block(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return step_block(*args, **kwargs)
            finally:
                self.block_s += time.perf_counter() - t0

        def timed_mixed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = step_mixed(*args, **kwargs)
            finally:
                self.mixed_s += time.perf_counter() - t0
            self.mixed_ticks += any(out)
            return out

        def counted_decode_block(state, step, tokens, write_at, active, budgets,
                                 page_table, *args, n_steps, fsm):
            self.decode_steps += n_steps
            n = int((active & (budgets > 0)).sum())
            if n > self._active:
                self._active = n
                self.block_args = (tokens.copy(), write_at.copy(), active.copy(),
                                   page_table.copy(), fsm.copy())
            return self._decode_block(state, step, tokens, write_at, active, budgets,
                                      page_table, *args, n_steps=n_steps, fsm=fsm)

        engine.step_block, engine.step_mixed = timed_block, timed_mixed
        engine_module.decode_block = counted_decode_block

    def reset(self) -> None:
        self.block_s = self.mixed_s = 0.0
        self.decode_steps = self.mixed_ticks = 0
        self.block_args = None
        self._active = -1

    def close(self) -> None:
        engine_module.decode_block = self._decode_block

    def fields(self) -> dict:
        return {
            "decode_steps": self.decode_steps,
            "decode_wall_ms_per_step": self.block_s * 1e3 / max(self.decode_steps, 1),
            "mixed_ticks": self.mixed_ticks,
            "mixed_wall_ms_per_tick": self.mixed_s * 1e3 / max(self.mixed_ticks, 1),
        }


def decode_device_ms(engine: Engine, block_args, fsm_rows: bool = True,
                     masked: bool = True) -> float:
    """Device time of one greedy decode step at the serve's own shapes (B =
    ``max_batch_size``, MaxP = ``max_pages_per_seq``, the serve's page
    table and lengths): ``Llama.decode_step``, the constraint mask at each
    row's FSM table row (all 0 unless ``fsm_rows``), the argmax and the FSM
    advance, as the decode step body runs them, by CUDA graph replay
    (``graph_ms``); without ``masked``, the forward and the argmax alone.
    The step rewrites the K/V that the serve wrote at those positions, with
    the same values."""
    tokens, write_at, active, table, fsm = (torch.from_numpy(a).to("cuda") for a in block_args)
    if not fsm_rows:
        fsm = torch.zeros_like(fsm)
    tables = engine._fsm

    def step(i):
        logits = engine.model.decode_step(tokens, write_at, engine.cache, table, active,
                                          backend=engine.cfg.paged_backend)
        if not masked:
            return logits.argmax(dim=-1)
        nxt = torch.where(tables.allowed(fsm), logits, NEG_INF).argmax(dim=-1)
        return tables.advance(fsm, nxt)

    with torch.inference_mode():
        return graph_ms(step)


def mixed_device_ms(engine: Engine) -> float:
    """Device time of one mixed tick at the largest bucket, over the inputs
    of the serve's last tick at that bucket (still in the engine's buffers
    for it): ``Llama.mixed_step`` plus the argmax, by CUDA graph replay."""
    state = engine._mixed[engine.cfg.mixed_buckets[-1]]
    with torch.inference_mode():
        return graph_ms(lambda i: engine.model.mixed_step(
            state.tokens, state.start, state.q_lens, engine.cache, state.page_table,
            backend=engine.cfg.paged_backend).argmax(dim=-1))


def post_stream(port: int, body: dict) -> tuple[int, dict]:
    """A chat completion with ``stream: true``: its status and a reply
    assembled from its events (the deltas' text, the last event's
    finish_reason, the event count)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        status, ctype, raw = r.status, r.headers["Content-Type"], r.read().decode()
    check(ctype == "text/event-stream", f"stream content type {ctype}")
    data = [block.removeprefix("data: ") for block in raw.split("\n\n") if block]
    check(data[-1] == "[DONE]", f"stream ends with {data[-1]!r}")
    chunks = [json.loads(d) for d in data[:-1]]
    check(chunks[0]["choices"][0]["delta"].get("role") == "assistant",
          f"first event {chunks[0]}")
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    return status, {"choices": [{"message": {"role": "assistant", "content": text},
                                 "finish_reason": chunks[-1]["choices"][0]["finish_reason"]}],
                    "events": len(chunks)}


def constrained_batch(engine: Engine, clock: TickClock, post, post_sse, prompt,
                      model: str, backend: str) -> dict:
    """Four concurrent requests, untimed, after the timed batch: two
    ToolPrompt json_schema completions (one streamed), one json_object,
    one unconstrained, 64 greedy tokens each. Each constrained reply is a
    live prefix of its DFA (and parses as JSON when it stopped). Every
    decode step and mixed tick replays; the ToolPrompt rows ride the
    device tables (loaded once), and only the json_object row (over the
    table budget at this vocab) takes hosted steps. Returns the batch's
    line, with the block arguments for its device times."""
    schema = {"type": "json_schema",
              "json_schema": {"name": "toolprompt", "schema": TOOLPROMPT_SCHEMA}}
    kinds = (("toolprompt", False, schema), ("toolprompt", True, schema),
             ("json_object", False, {"type": "json_object"}), ("none", False, None))
    bodies = []
    for (kind, streamed, rf), n in zip(kinds, (300, 800, 1500, 600)):
        body = {"model": model, "temperature": 0, "max_tokens": 64,
                "messages": [{"role": "user", "content": prompt(n)}]}
        if rf:
            body["response_format"] = rf
        bodies.append((streamed, body))
    clock.reset()
    reset_launch_counts()
    before = (*routes(engine), engine.hosted_steps, engine.fsm_loads, engine.fsm_load_s)
    with ThreadPoolExecutor(len(bodies)) as ex:
        replies = list(ex.map(lambda b: (post_sse if b[0] else post)(b[1]), bodies))
    torch.cuda.synchronize()
    replays, eager_steps, mixed_replays, eager_ticks, hosted, loads, load_s = (
        n - was for n, was in zip(
            (*routes(engine), engine.hosted_steps, engine.fsm_loads, engine.fsm_load_s),
            before))
    launches = launch_counts()
    ticks = clock.fields()
    label = f"constrained batch, {model} {backend}"
    check(replays == ticks["decode_steps"] > 0 and eager_steps == 0,
          f"{label}: {replays} replayed and {eager_steps} eager decode steps of "
          f"{ticks['decode_steps']}")
    check(mixed_replays == ticks["mixed_ticks"] > 0 and eager_ticks == 0,
          f"{label}: {mixed_replays} replayed and {eager_ticks} eager mixed ticks")
    requests = []
    for (kind, streamed, _), (status, r) in zip(kinds, replies):
        check(status == 200, f"{label}: {kind} status {status}")
        ch = r["choices"][0]
        text, finish = ch["message"]["content"], ch["finish_reason"]
        check(finish in ("stop", "length"), f"{label}: {kind} finish {finish}")
        row = {"kind": kind, "streamed": streamed, "finish_reason": finish,
               "bytes": len(text.encode())}
        if kind != "none":
            dfa = json_constraint(engine.tokenizer,
                                  None if kind == "json_object" else TOOLPROMPT_SCHEMA).fsm.dfa
            st = dfa.run(dfa.start, text.encode())
            check(st >= 0, f"{label}: {kind} reply leaves its DFA: {text!r}")
            if finish == "stop":
                check(bool(dfa.accept[st]), f"{label}: {kind} stopped short: {text!r}")
                json.loads(text)
            row["live_prefix"] = True
        if not streamed:
            row["completion_tokens"] = r["usage"]["completion_tokens"]
        requests.append(row)
    toolprompt = json_constraint(engine.tokenizer, TOOLPROMPT_SCHEMA).fsm
    check(engine._fsm_loaded is toolprompt and loads == 1,
          f"{label}: {loads} table loads, the ToolPrompt tables not resident")
    check(0 < hosted <= requests[2]["completion_tokens"] - 1,
          f"{label}: {hosted} hosted steps for a json_object reply of "
          f"{requests[2]['completion_tokens']} tokens")
    expected = expected_kernels(backend, "", "")
    for name, n in launches.items():
        check((n > 0) == (name in expected), f"{label}: {name} launched {n} times")
    rows = toolprompt.dfa.num_states + 1
    V = engine.model_cfg.vocab_size
    return {
        "requests": requests,
        "fsm_table_bytes": sum(t.numel() * t.element_size()
                               for t in (engine._fsm.mask, engine._fsm.dest)),
        "fsm_loaded_bytes": rows * V * 5,
        "fsm_loads": loads,
        "fsm_load_ms": load_s * 1e3,
        "hosted_steps": hosted,
        **{k: ticks[k] for k in ("decode_steps", "mixed_ticks")},
        "decode_replays": replays, "decode_eager_steps": eager_steps,
        "mixed_replays": mixed_replays, "mixed_eager_ticks": eager_ticks,
        "launches": launches,
        "block_args": clock.block_args,
    }


def phase_serve(seed: int, smi: str, profile: bool, model: str, backend: str,
                quantize: str, kv_quantize: str) -> dict:
    engine = Engine(EngineConfig(model=model, dtype=torch.bfloat16,
                                 device="cuda", seed=seed, quantize=quantize,
                                 kv_quantize=kv_quantize, paged_backend=backend))
    cfg = get_config_preset(model)
    weights = sum(t.numel() * t.element_size() for t in itertools.chain(
        engine.model.parameters(), engine.model.buffers()))
    # Before the scheduler thread starts: the capture is process-wide.
    warmup_s = engine.warmup()
    clock = TickClock(engine)
    stack = ServingStack(engine)
    server = make_server(stack, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    gen = torch.Generator().manual_seed(seed)
    letters = "abcdefghijklmnopqrstuvwxyz     .,\n"

    def prompt(n: int) -> str:
        idx = torch.randint(0, len(letters), (n,), generator=gen).tolist()
        return "".join(letters[i] for i in idx)

    bodies = [
        {"model": model, "temperature": 0, "max_tokens": 64,
         "messages": [{"role": "user", "content": prompt(n)}]}
        for n in (300, 800, 1500, 3000)
    ]

    def post(body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())

    fsm_run = None
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        routes_before = routes(engine)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]) if profile else nullcontext()
        t0 = time.perf_counter()
        with prof:
            with ThreadPoolExecutor(len(bodies)) as ex:
                replies = list(ex.map(post, bodies))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        instances = dict(qm.INSTANCE_LAUNCHES)
        replays, eager_steps, mixed_replays, eager_ticks = (
            n - was for n, was in zip(routes(engine), routes_before))
        peak = torch.cuda.max_memory_allocated()
        ticks, block_args = clock.fields(), clock.block_args
        if not quantize:
            # Keep the timed batch's last largest-bucket tick for
            # mixed_device_ms: the constrained batch runs its own.
            last_tick = engine._mixed[engine.cfg.mixed_buckets[-1]]
            saved = [t.clone() for t in last_tick.buffers()]
            fsm_run = constrained_batch(engine, clock, post,
                                        lambda body: post_stream(port, body), prompt,
                                        model, backend)
            with torch.inference_mode():
                for t, was in zip(last_tick.buffers(), saved):
                    t.copy_(was)
    finally:
        server.shutdown()
        server.server_close()
        stack.close()
        thread.join(timeout=30)
        clock.close()
    check(block_args is not None, "the serve ran no decode block")
    # The step with its constraint mask and FSM advance, and without them,
    # alternated on the same engine and inputs.
    alternated = {"masked": [], "unmasked": []}
    for masked in (True, False, False, True):
        alternated["masked" if masked else "unmasked"].append(
            decode_device_ms(engine, block_args, masked=masked))
    ticks["decode_device_ms_per_step"] = alternated["masked"][0]
    ticks["decode_device_ms_alternated"] = alternated
    ticks["mixed_device_ms_per_tick"] = mixed_device_ms(engine)
    if fsm_run is not None:
        # With the rows at their FSM states and at row 0, alternated, twice.
        fsm_args = fsm_run.pop("block_args")
        for key, rows in (("fsm", True), ("free", False), ("free", False), ("fsm", True)):
            fsm_run.setdefault(f"decode_device_ms_per_step_{key}", []).append(
                decode_device_ms(engine, fsm_args, fsm_rows=rows))
        emit({"phase": "constrained", "model": model, "paged_backend": backend,
              "card": smi, **fsm_run})
    # Every decode step and every mixed tick of the serve is a graph replay.
    check(replays == ticks["decode_steps"] > 0 and eager_steps == 0,
          f"{replays} replayed and {eager_steps} eager decode steps of "
          f"{ticks['decode_steps']}")
    check(mixed_replays == ticks["mixed_ticks"] > 0 and eager_ticks == 0,
          f"{mixed_replays} replayed and {eager_ticks} eager mixed ticks of "
          f"{ticks['mixed_ticks']}")
    for status, r in replies:
        check(status == 200, f"status {status}")
        check(r.get("object") == "chat.completion" and r["id"].startswith("chatcmpl-"),
              f"reply shape {list(r)}")
        ch = r["choices"][0]
        check(ch["message"]["role"] == "assistant"
              and isinstance(ch["message"]["content"], str)
              and ch["finish_reason"] in ("stop", "length"), f"choice {ch}")
        u = r["usage"]
        check(u["completion_tokens"] >= 1
              and u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"],
              f"usage {u}")
    # One attention launch per layer per forward; quantized weights add one
    # matmul per projection (7 per layer) and one for the lm_head.
    expected = expected_kernels(backend, quantize, kv_quantize)
    for name, n in launches.items():
        if name not in expected:
            check(n == 0, f"{name} launched {n} times in a run that must not use it")
            continue
        every = 7 * cfg.num_layers + 1 if name.startswith("quant_matmul") else cfg.num_layers
        check(n > 0 and n % every == 0,
              f"{name} launched {n} times, not a positive multiple of {every}")
    # Every projection of every mixed tick (T = 8 x bucket > 16) on the m128
    # instance; decode steps and every lm_head (T = 8) on m16; r16, m64 and
    # f32 never.
    mixed, projections = instances["quant_matmul_m128"], 7 * cfg.num_layers
    if quantize:
        check(mixed == projections * ticks["mixed_ticks"] > 0,
              f"quant_matmul_m128 launched {mixed} times, not {projections} for "
              f"each of {ticks['mixed_ticks']} mixed ticks")
    total = sum(launches[name] for name in qm.LAUNCHES)
    check(instances["quant_matmul_m16"] == total - mixed
          and instances["quant_matmul_r16"] == instances["quant_matmul_m64"]
          == instances["quant_matmul_f32"] == 0,
          f"quantized matmul instances {instances}")
    completion = sum(r["usage"]["completion_tokens"] for _, r in replies)
    if profile:
        groups = device_time_by_group(prof)
        emit({"phase": "profile", "model": model, "paged_backend": backend,
              "quantize": quantize or "none",
              "kv_quantize": kv_quantize or "none", "card": smi,
              "wall_ms": wall * 1e3, "device_ms": groups,
              "device_busy_share": sum(groups.values()) / (wall * 1e3)})
    return {
        "model": model,
        "layers": cfg.num_layers,
        "paged_backend": backend,
        "quantize": quantize or "none",
        "kv_quantize": kv_quantize or "none",
        "card": smi,
        "weights_bytes": weights,
        "prompt_tokens": [r["usage"]["prompt_tokens"] for _, r in replies],
        "completion_tokens": completion,
        "wall_s": wall,
        "completion_tok_per_s": completion / wall,
        "ttft_p50_s": statistics.median(r["ttft_s"] for _, r in replies),
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "matmul_instances": instances,
        "warmup_s": warmup_s,
        "decode_replays": replays,
        "decode_eager_steps": eager_steps,
        "mixed_replays": mixed_replays,
        "mixed_eager_ticks": eager_ticks,
        **ticks,
        "constrained_launches": fsm_run["launches"] if fsm_run else {},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phases and report device time by kernel group")
    args = ap.parse_args()

    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "seconds": time.perf_counter() - t, "card": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})

    t = time.perf_counter()
    built = phase_build()
    emit({"phase": "build", "seconds": time.perf_counter() - t, **built})

    t = time.perf_counter()
    kernels = phase_kernels(args.seed)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t, "card": smi,
          **kernels})

    t = time.perf_counter()
    matmul_timed, matmul_rows = phase_matmul(args.seed)
    torch.cuda.empty_cache()
    emit({"phase": "matmul", "seconds": time.perf_counter() - t, "card": smi,
          "timed": matmul_timed})

    t = time.perf_counter()
    e2e = phase_e2e(args.seed)
    emit({"phase": "e2e", "seconds": time.perf_counter() - t, **e2e})

    t = time.perf_counter()
    e2e_bf16 = phase_e2e_bf16(args.seed)
    emit({"phase": "e2e_bf16", "seconds": time.perf_counter() - t, **e2e_bf16})

    t = time.perf_counter()
    hf = phase_hf()
    emit({"phase": "hf", "seconds": time.perf_counter() - t, **hf})

    t = time.perf_counter()
    graphs = phase_decode_graph(args.seed)
    emit({"phase": "decode_graph", "seconds": time.perf_counter() - t, "card": smi,
          **graphs})

    launches = {name: 0 for name in KERNELS}
    for model, backend, quantize, kv_quantize in SERVES:
        t = time.perf_counter()
        serve = phase_serve(args.seed, smi, args.profile, model, backend,
                            quantize, kv_quantize)
        # The server's handler class holds the engine in a reference
        # cycle: collect it before the next configuration measures its
        # peak memory.
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "serve", "seconds": time.perf_counter() - t, **serve})
        for name in expected_kernels(backend, quantize, kv_quantize):
            launches[name] += (serve["launches"][name]
                               + serve["constrained_launches"].get(name, 0))

    # A matmul's row is its decode-step shape (T = 8); the matmul phase
    # line also gives the mixed ticks' shapes (T = 128 and 1024).
    timed = {**kernels, **matmul_rows}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = timed[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"opsagent_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("event_ms", "dma_ms") if k in r},
        })
    print(smi)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
