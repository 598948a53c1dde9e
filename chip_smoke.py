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
   bench-1b and tiny-test; and the dma kernels' MLA latent instances (one
   latent kv head of 576 columns read as k and v) at DeepSeek-V2-Lite's 16
   and V3's 128 heads, bf16 and f32, decode lengths on page and split
   edges and 0; the main path's bf16 shapes are timed: device
   times by CUDA graph replay (the kernels cycling over copies of the
   pages that pass ``ROTATE_BYTES``; SDPA over K/V gathered once), and
   the kernels' calls from Python beside them (``event_ms``); then (the
   ``matmul`` line) the quantized matmul, int8 and
   int4 with one whole-axis group and with groups of 128, at every
   bench-8b projection shape, Qwen2.5-7B's wk/wv and wg/wu, and every
   DeepSeek-V2-Lite projection (MLA, dense MLP, a routed expert's slice,
   the shared experts, lm_head) with T in {1, 8, 128, 1024}, at aligned and unaligned edges (a ragged In, an int4
   group that straddles stages, an odd group) and at tiny-test widths.
   Errors for all; in bf16, device times (CUDA graph replay) of the mixed
   ticks' shapes (T = 128 and 1024; V2-Lite's expert slices at 1024) and
   of every served shape at a decode
   step (T = 8), each with its instance, its bound, cuBLAS's time and the
   time of the older instance on the same inputs (m64 at T > 16, r16 at
   T <= 16, with the m16 instance's split count), and the kernel's time
   through its Python wrapper, host included (``event_ms``).
4. e2e: 2-layer f32 cuts of bench-8b (dma kernels; unquantized, int8
   weights + int8 KV, int4 weights + int8 KV), of Qwen2.5-7B (grid
   kernels; unquantized, int8 + int8 KV) and of DeepSeek-V2-Lite (one
   dense and one MoE layer, latent kernels; unquantized, int8, int4):
   ``Engine.generate`` through the kernels gives exactly the greedy tokens
   of the same engine through the plain versions, with a prefix-cache
   hit. Then (``e2e_bf16``) the same cuts in bf16, bf16 pages and int8 KV
   (not for MLA): the first mixed step's last-position logits through the
   kernels against the plain path's.
5. hf: the HF-written fixtures
   ``tests/fixtures/tiny-{llama,qwen2,qwen3,qwen3-moe}-hf`` and the DeepSeek
   MoE fixture ``tiny-deepseek-moe`` (``tiny-moe`` preset, dma only) loaded
   by the port's loader onto the card: last-position logits through the
   kernels within 2e-4 of the golden ones, and greedy tokens equal to the
   golden ones under both paged backends.
6. decode_graph: at full width and depth (bench-8b on the dma kernels in
   bf16 and with int8 weights + int8 KV, Qwen2.5-7B on the grid kernels in
   bf16) and DeepSeek-V2-Lite at full width and 2 layers (bf16, the MoE
   scan and the latent kernels inside the graphs), three engines over one model with one seed, two replaying the
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
6b. serve_loop: the JAX engine's default loop (async mixed ticks at depth
   2, pipelined blocks at depth 2, grammar fast-forward on) against the
   synchronous one (depth 1 / 0, fast-forward off), at bench-8b width: f32
   on the dma and on the grid kernels and f32 activations with int8
   weights + int8 KV on dma, cut to 2 layers, and bf16 on dma at full
   depth. Two engines over
   one model each, warmed up; one concurrent greedy batch through a
   ServingStack: three ToolPrompt json_schema requests and a plain one
   that outlives them (pipelined blocks after the constrained rows end).
   In f32 every reply is equal across the loops (bf16: reported, not
   checked: the loops compute a forced run's successor through different
   kernels); on the default loop fast-forward dispatches are skipped (> 0;
   0 on the reference) and blocks pipelined; no capture after warmup; no
   page owned after either batch. On the f32 dma model: one completion
   through the port's ``ChatClient("cuda://bench-8b")`` equals the same
   request over HTTP, and an engine whose blocks all raise after the first
   token is rebuilt through ``engine_factory``, warmed up, and its request
   completes with the uninterrupted tokens. Then the ragged kernel (both
   forms, bf16 and int8 pages) against its plain version at the
   fast-forward shapes (bucket 16, q_len 2-13, starts 200-4000), the bf16
   pages timed by graph replay beside their bound and SDPA.
6b'. agent: the port's agent stack. (a) The trained tiny agent
   (``tests/fixtures/tiny-agent-hf``, f32 on the dma kernels, installed as
   ``cuda://tiny-agent``) runs its instruction through the port's
   ``assistant_with_config`` with the replay kubectl, which refuses every
   command but the trained one: the memorized final answer, the tool run
   once, and one transcript with the conveyor on, with it off and on an
   engine through the plain path (``attn_impl="plain"``, no kernel
   launched); then the port's agent server: ``/login``, ``POST
   /api/execute`` on ``cuda://tiny-agent`` (its own system prompt) gives
   the same answer, the request's trace holds ``llm_turn`` (the engine's
   spans under it) and ``tool_exec``, and ``/metrics`` counts its
   iterations and tool calls. (b) bench-8b at full width and depth, bf16,
   dma, random weights from ``--seed``: the loop at
   ``AGENT_FULL_ITERATIONS`` iterations and ``AGENT_FULL_TOKENS`` tokens a
   reply with every tool an in-process stub, on two fresh engines over one
   model (conveyor on, off): one transcript, every constrained reply a
   live prefix of the ToolPrompt DFA (JSON where it stopped); its line
   (``agent_full_width``, with the card) gives each turn's TTFT and decode
   tokens/s, the stub tools' calls and time and the parked tokens.
6c. offload: the host KV tier at bench-8b width. At full depth in bf16
   pages, an engine with the tier and one without (and a cold one), over
   one model: four sessions' first turns (993-2993 prompt tokens, 16
   greedy tokens) equal on both; the longest history parked to host RAM
   (``park_chain`` + ``offload_flush``, timed: spill GB/s), its next turn
   admitted (the admission's restore timed: restore GB/s): the restored
   pages hold the parked bytes exactly and the continuation equals the
   never-parked engine's, whose next turn hits its HBM trie; the cold
   engine re-prefills the same tokens (``reprefill_ms`` against
   ``restore_ms``, TTFT re-prefilled against restored); an untimed round
   trip first allocates the pinned blocks. The serve loop's ``host_ms``
   over one concurrent batch with the tier on and off. The same round trip
   in int8 pages. At 2 layers in f32: six concurrent sessions in 400
   pages (of the 753 their prompts need) through the scheduler: pressure
   parking fires, every reply equals the run with ample pages, no
   ``restore_reprefill``; a park and restore on a replaying engine and an
   eager one: tokens and every cache byte equal, all steps replayed. Then
   DeepSeek-V2-Lite's latent pages (27 layers, one 576-column latent a
   token) gathered and scattered bit-exactly at bucket 1, 8 and a partial
   bucket with a duplicated id, the scratch slot untouched. No capture
   after warmup anywhere.
6d. snapshot: bench-8b at full width and ``SNAPSHOT_LAYERS`` (8) layers with
   int8 weights and int8 KV, warmed; ``snapshot``
   into ``build/chip_smoke_snapshot`` (write s, bytes), ``verify_snapshot``
   (full digests); then this script in a fresh process
   (``--restore-snapshot``) with an empty kernel directory
   (``OPSAGENT_KERNEL_DIR``): ``Engine.from_snapshot`` with warmup and one
   greedy request, whose tokens equal the source engine's, with no nvcc
   run (the snapshot's libraries pre-seeded) and its restore-to-first-
   token seconds. The snapshot and the kernel directory are deleted after.
7. serve: behind the HTTP server, random weights from ``--seed``, bf16
   activations, four concurrent chat completions per run, on the default
   loop (async ticks, pipelined blocks, fast-forward): bench-8b at full
   depth on the dma kernels (int8 weights + int8 KV, int4 weights + int8
   KV), Qwen2.5-7B-Instruct at full depth on the grid kernels
   (unquantized, int8 weights + int8 KV), DeepSeek-V2-Lite at full width
   and depth (27 layers, MLA latent cache, 64 experts top-6 + 2 shared,
   bf16) on the dma kernels' latent instances, then bench-8b unquantized
   on the dma kernels, each engine warmed up (``warmup_s``) before the server
   starts. Each serve line has an ``obs`` block read from the serve's own
   server over its timed window: ``/metrics`` parsed against the
   exposition grammar of ``tests/test_metrics_conformance.py``, its
   counters equal to the serve's own counts (decode tokens, TTFT count,
   prefill + prefix-hit tokens, block and mixed dispatches, completed
   requests), ``opsagent_post_warmup_compiles`` 0, MFU and HBM
   utilization at the H100's peaks in (0, 1.05] with the drift and the
   bytes by kind; one reply's trace spans and timeline; the flight ring's
   dispatch events, and anomalies only of TTFT breaches past 500 ms and
   the SLO breach a scrape evaluates. The bench-8b bf16 serve, last
   because a capture leaves later mixed ticks slower, then sends ``POST
   /api/debug/profile?seconds=2`` beside four more requests (the Chrome
   trace must name its kernels and the ``engine.*`` annotations), writes a
   memory snapshot through ``GET /api/debug/memory`` and times one more
   batch after the capture (``profile_capture``). The kernels' launch
   counts of each run are checked and reported, and the quantized
   matmul's by instance: the m128 instance takes every projection of every
   mixed tick (7 x layers launches a tick), the m16 instance the rest
   (decode steps, the lm_head), and r16, m64 and f32 none. Every decode
   step and mixed tick must be a graph replay (``decode_replays`` =
   ``decode_steps``, ``mixed_replays`` = ``mixed_ticks``, no eager ones;
   ``mixed_ticks`` counts the synchronous ticks, the async ticks and the
   fast-forward appends, each a replay of a mixed graph, and the ``obs``
   block holds each to its own dispatch counter). Each serve line then
   gives, as information, four more requests of new prompts of the same
   lengths on the synchronous loop (``depth1``: tok/s, TTFT p50, ticks),
   the defaults restored after.
   The host's split, untraced: ``decode_steps`` (the sum of ``n_steps``
   over the ``decode_block`` calls) and ``mixed_ticks``, each with its
   host wall time per step or tick (``step_block`` and ``step_mixed``
   under ``time.perf_counter``), beside their device times by CUDA graph
   replay: ``decode_device_ms_per_step``, one decode step plus its argmax
   at the serve's shapes and page table, and ``mixed_device_ms_per_tick``,
   one tick at the largest bucket over the serve's last such tick's
   inputs. After the timed batch of each bf16 serve (bench-8b dma,
   Qwen2.5-7B grid, DeepSeek-V2-Lite), a ``constrained`` line: four more requests, untimed
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
   ones). After the Qwen2.5-7B bf16 serve, a ``bpe`` line: an engine over
   that serve's model with ``BPETokenizer`` on ``tests/fixtures/tiny-bpe``
   (1,027 ids against the model's 152,064) serves one json_schema request
   over HTTP with a ChatML prompt, every step replayed; the reply parses
   and the FSM is built from the BPE's token bytes.
8. chat_api: bench-8b at full width and depth, dma kernels, bf16, one
   model under a replaying and an eager engine. A forced named
   ``tool_choice`` with ``n`` = 2 over HTTP (both choices call the tool,
   arguments parse, choices equal); a batch of four plain rows beside a
   ``logit_bias`` row, a penalty row, a logprobs row (top 5) and one with
   all three, replayed and eager: greedy tokens equal, logprobs within
   the e2e_bf16 phase's bf16 cost, every row a full first block; a -100
   bias on a plain row's first greedy token moves it; no eager and no
   hosted step on the replaying engine. The decode step's device time by
   replay of the engine's graph without the extras and of its graph with
   them (an extras row loaded), alternated (``extras_cost_ms``).

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
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from opsagent_tpu_torch import obs
from opsagent_tpu_torch.models.config import (
    BENCH_8B,
    DEEPSEEK_V2_LITE,
    QWEN25_7B,
    config_from_hf,
    get_config_preset,
)
from opsagent_tpu_torch.models.llama import Llama, PagedKVCache
from opsagent_tpu_torch.models.loader import load_checkpoint
from opsagent_tpu_torch.models.quant import quantize_weight, quantize_weight4
from opsagent_tpu_torch.ops import cuda_build
from opsagent_tpu_torch.ops import paged_attention as pa
from opsagent_tpu_torch.ops import quant_matmul as qm
from opsagent_tpu_torch.ops.attention import QuantizedPages, _gather_kv, write_kv_pages
from opsagent_tpu_torch.serving import engine as engine_module
from opsagent_tpu_torch.serving.api import ServingStack, make_server
from opsagent_tpu_torch.serving.chat_template import apply_chat_template
from opsagent_tpu_torch.serving.constrained import TOOLPROMPT_SCHEMA, json_constraint
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig, Sequence
from opsagent_tpu_torch.serving.offload import PageCopyEngine
from opsagent_tpu_torch.serving.scheduler import Request
from opsagent_tpu_torch.serving.sampler import NEG_INF, SamplingParams
from opsagent_tpu_torch.serving.snapshot import verify_snapshot
from opsagent_tpu_torch.serving.tokenizer import BPETokenizer, ByteTokenizer
from opsagent_tpu_torch.utils.perf import get_perf_stats

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
    # The MLA latent instances of the dma kernels: the function the JAX
    # model's latent path calls (k = v = the latent pages); its Pallas dma
    # kernels compute it in interpret mode.
    "paged_ragged_attention_latent": ("paged_attention.cu", "opsagent_tpu/ops/attention.py:456"),
    "paged_decode_attention_latent": ("paged_attention.cu", "opsagent_tpu/ops/attention.py:608"),
}
LATENT_KERNELS = ("paged_ragged_attention_latent", "paged_decode_attention_latent")
# (model, paged backend, quantize, kv_quantize) of each serve run. The
# bench-8b dma bf16 serve runs last: after its timed batch it runs a
# torch.profiler capture, and a capture leaves every later mixed tick of
# the process slower (its line reports the batch after the capture).
SERVES = (
    ("bench-8b", "dma", "int8", "int8"),
    ("bench-8b", "dma", "int4", "int8"),
    ("qwen2.5-7b-instruct", "grid", "", ""),
    ("qwen2.5-7b-instruct", "grid", "int8", "int8"),
    ("deepseek-v2-lite", "dma", "", ""),
    ("bench-8b", "dma", "", ""),
)
# (2-layer cut, paged backend, quantize, kv_quantize) of each e2e check.
E2E = (
    (BENCH_8B, "dma", "", ""),
    (BENCH_8B, "dma", "int8", "int8"),
    (BENCH_8B, "dma", "int4", "int8"),
    (QWEN25_7B, "grid", "", ""),
    (QWEN25_7B, "grid", "int8", "int8"),
    # One dense layer and one MoE layer of DeepSeek-V2-Lite: the latent
    # kernels, and with quantized weights every expert slice through the
    # quantized matmul.
    (DEEPSEEK_V2_LITE, "dma", "", ""),
    (DEEPSEEK_V2_LITE, "dma", "int8", ""),
    (DEEPSEEK_V2_LITE, "dma", "int4", ""),
)
# (2-layer cut, paged backend) of each bf16 logits check, each with bf16
# pages and with int8 KV; the q_lens of its first mixed step, all rows
# from position 0.
E2E_BF16 = ((BENCH_8B, "dma"), (QWEN25_7B, "grid"), (DEEPSEEK_V2_LITE, "dma"))
E2E_BF16_Q_LENS = [128, 128, 77, 1, 33, 0, 128, 5]
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
# Where the bench-8b dma bf16 serve's profiling routes write (gitignored,
# removed once checked).
PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_profile")
BPE_FIXTURE = os.path.join(FIXTURES, "tiny-bpe")
# fixture: (configuration, "auto" for its config.json or a preset; backends)
HF_FIXTURES = {
    "tiny-llama-hf": ("auto", ("dma", "grid")),
    "tiny-qwen2-hf": ("auto", ("dma", "grid")),
    "tiny-qwen3-hf": ("auto", ("dma", "grid")),
    "tiny-qwen3-moe-hf": ("auto", ("dma", "grid")),
    "tiny-deepseek-moe": ("tiny-moe", ("dma",)),
}
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
    m128 and m16 instances) and of the six latent kernels (ragged and
    decode: f32 on CUDA cores, bf16 on warpgroups with their merge
    kernels; the bf16 ones must not spill) into the phase line."""
    sources = sorted({src for src, _ in KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(lambda s: cuda_build.build(s, verbose=True), sources))
    tensor_core, decode, m128, m16, latent = [], [], [], [], []
    for _, log in built:
        print(log, file=sys.stderr)
        report = ptxas_report(log)
        latent += [r for r in report if "latent" in r["kernel"]]
        report = [r for r in report if "latent" not in r["kernel"]]
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
    # f32 ragged and decode (CUDA cores); bf16 ragged and decode
    # (warpgroups) and their merge kernels.
    check(len(latent) == 6, f"ptxas reported {len(latent)} latent kernels, expected 6")
    for r in latent:
        if "_wg_kernel" in r["kernel"]:
            check(r.get("spill_stores", 0) == 0 and r.get("spill_loads", 0) == 0,
                  f"{r['kernel']} spills: {r}")
    return {"libraries": [lib.name for lib, _ in built], "ptxas_tensor_core": tensor_core,
            "ptxas_decode": decode, "ptxas_quant_matmul_m128": m128,
            "ptxas_quant_matmul_m16": m16, "ptxas_latent": latent}


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
    ``[B, H, D]`` q). Bytes, each once: the K/V rows each sequence can see
    (the latent rows once: k and v are one array),
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
    planes = 1 if c["k"] is c["v"] else 2
    nbytes = (
        sum(n for _, n in rows) * H * D * elt
        + q.numel() * elt
        + planes * sum(visible) * K * row_bytes
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

    if c["k"] is c["v"]:  # latent pages: one array read as k and v
        n = math.ceil(ROTATE_BYTES / nbytes(c["k"]))
        return [(c["k"], c["k"])] + [(k, k) for k in (clone(c["k"]) for _ in range(n - 1))]
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


def latent_plan_bytes(c, blocks: int) -> dict:
    """The bf16 latent kernels' plan on case ``c`` (``pa.latent_plan``):
    busy blocks, tiles cut between blocks and the bytes of their partials
    (written once and read once by the merge), beside the latent bytes the
    call must read (each visible position's row once)."""
    q, P = c["q"], c["k"].shape[1]
    cap = c["table"].shape[1] * P
    if q.ndim == 4:
        starts, q_lens = c["start"].tolist(), c["q_lens"].tolist()
        lens = pa.latent_lens(q.shape[1], q.shape[2], cap, start=starts, q_lens=q_lens)
        seen = [min(s + n, cap) if n else 0 for s, n in zip(starts, q_lens)]
        rows = min(pa.LATENT_TILE_ROWS, q.shape[1] * q.shape[2])
    else:
        lengths = c["lengths"].tolist()
        lens = pa.latent_lens(1, q.shape[1], cap, lengths=lengths)
        seen = [min(max(n, 0), cap) for n in lengths]
        rows = min(pa.LATENT_TILE_ROWS, q.shape[1])
    per, runs = pa.latent_plan(lens, blocks)
    cut = sum(u["cut"] for units in runs for u in units)
    return {"blocks": blocks, "per": per, "busy_blocks": sum(1 for r in runs if r),
            "tiles": len(lens), "cut_pieces": cut,
            "partial_bytes": 2 * cut * rows * (pa.LATENT_DIM + 2) * 4,
            "latent_bytes": sum(seen) * pa.LATENT_DIM * 2}


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

    # The MLA latent instances (dma form): DeepSeek-V2-Lite's 16 heads and
    # V3's 128 over one latent kv head of 576 columns, one page array as k
    # and v; the ragged rows above, and decode lengths on page and split
    # edges (DECODE_WALK positions a split of the f32 instance; the bf16
    # plan cuts at its own runs) beside a zero-length row. The main path's
    # shapes (V2-Lite, bf16: the bucket-128 tick and the decode step) are
    # timed, each with its plan's cut tiles and partial bytes.
    walk = pa.DECODE_WALK
    latent_decode = [0, 1, 16, walk - 1, walk, walk + 1, 2049, 4096]

    def latent(name, c, dtype, wname, int_arrays, timed, **where):
        c["v"] = c["k"]
        if timed:
            c["bound"] = attention_bound_ms(c, int_arrays)
            q = c["q"] if c["q"].ndim == 4 else c["q"][:, None]
            c["sdpa"] = ragged_sdpa({**c, "q": q})
        r = run_kernel_case(name, c, dtype, timed)
        if timed:
            r["plan"] = latent_plan_bytes(c, pa.latent_blocks(pa._sm_count(c["q"].device)))
        cases.append(dict(kernel=name, width=wname, **where, dtype=str(dtype)[6:],
                          err=r["max_abs_err"], tol=TOL[dtype]))
        if timed:
            results[name] = r

    for dtype in (torch.bfloat16, torch.float32):
        for wname, H in (("deepseek-v2-lite", 16), ("deepseek-v3", 128)):
            main = dtype == torch.bfloat16 and wname == "deepseek-v2-lite"
            for S, (starts, lens) in ragged_rows.items():
                c = make_case(gen, 8, S, H, 1, pa.LATENT_DIM, 16, starts, lens, dtype)
                latent("paged_ragged_attention_latent", c, dtype, wname, 2,
                       main and S == 128, S=S)
                del c
            c = decode_case(gen, 8, H, 1, pa.LATENT_DIM, 16, latent_decode, dtype)
            latent("paged_decode_attention_latent", c, dtype, wname, 1, main)
            del c
            torch.cuda.empty_cache()
    emit({"phase": "kernels_cases", "cases": cases})
    return results


# -- phase 3: the quantized matmul against its plain version -------------------
MM_SHAPES = {  # the served projections: (In, Out)
    "wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "wg/wu": (4096, 14336),
    "wd": (14336, 4096), "lm_head": (4096, 128256),
    "qwen wk/wv": (3584, 512), "qwen wg/wu": (3584, 18944),
}
# DeepSeek-V2-Lite's: the MLA projections (wo over the padded head dim),
# the dense layer's MLP, a routed expert's 2-D slice (every expert of every
# MoE layer runs one such call for each of its three projections), the two
# shared experts as one, and the lm_head.
MM_V2L = {
    "v2l wq": (2048, 3072), "v2l wdkv": (2048, 512), "v2l wkr": (2048, 64),
    "v2l wukv": (512, 4096), "v2l wo": (3072, 2048), "v2l wg/wu": (2048, 10944),
    "v2l wd": (10944, 2048), "v2l eg/eu": (2048, 1408), "v2l ed": (1408, 2048),
    "v2l sg/su": (2048, 2816), "v2l sd": (2816, 2048), "v2l lm_head": (2048, 102400),
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
            | {("v2l eg/eu", 1024), ("v2l ed", 1024)}
            | {(s, 8) for s in (*MM_SHAPES, *MM_V2L)})


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
    for label, (In, Out) in {**MM_SHAPES, **MM_V2L, **MM_EXTRA}.items():
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
        refusals = mla_refusals(model, cfg) if cfg.mla is not None and not quantize else None
        del model
        torch.cuda.empty_cache()
        label = (f"{cfg.name} {backend}, weights {quantize or 'f32'}, "
                 f"kv {kv_quantize or 'f32'}")
        (tk, hk), (tp, hp) = out["cuda"], out["plain"]
        check(all(len(t) == 16 for t in tk), f"{label}: kernel path lengths {[len(t) for t in tk]}")
        check(tk == tp, f"{label}: kernel-path tokens {tk} != plain-path tokens {tp}")
        check(hk > 0 and hp == hk, f"{label}: prefix hits {hk} / {hp}")
        report[label] = {"tokens_equal": True, "prefix_hit_tokens": hk, "tokens": tk}
        if refusals is not None:
            report[f"{cfg.name} refusals"] = refusals
    return report


def mla_refusals(model: Llama, cfg) -> dict:
    """On the card the MLA path raises where its kernels do not take the
    shape, rather than running the plain version: a materialized cache
    (latent_cache off: head dim 192 over 16 kv heads) through the dma
    kernels, and the latent pages as k beside other pages as v."""
    dense = replace(cfg, mla=replace(cfg.mla, latent_cache=False))
    cache = PagedKVCache(dense, 8, 16, model.dtype, torch.device("cuda"))
    ints = dict(dtype=torch.int32, device="cuda")
    table = torch.arange(8, **ints)[None]
    out = {}
    try:
        with torch.inference_mode():
            model.mixed_step(torch.ones(1, 16, dtype=torch.long, device="cuda"),
                             torch.zeros(1, **ints), torch.full((1,), 16, **ints), cache, table)
    except ValueError as e:
        out["materialized_cache"] = str(e)
    check("materialized_cache" in out and "head dim 192" in out["materialized_cache"],
          f"a materialized MLA cache on the card: {out}")
    pages = torch.zeros(8, 16, 1, pa.LATENT_DIM, dtype=model.dtype, device="cuda")
    q = torch.zeros(1, cfg.num_heads, pa.LATENT_DIM, dtype=model.dtype, device="cuda")
    try:
        pa.paged_decode_attention_cuda(q, pages, pages.clone(), table, torch.ones(1, **ints))
    except ValueError as e:
        out["k_is_not_v"] = str(e)
    check("k_is_not_v" in out, "latent pages beside other pages as v did not raise")
    return out


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
        # MLA refuses int8 KV, as in the JAX engine.
        for kv_quantize in ("",) if cfg.mla else ("", "int8"):
            def last_logits(m, plain):
                cache = m.make_cache(B * pages, P, kv_quantize)
                with torch.inference_mode():
                    return m.mixed_step(tokens, start, q_lens, cache, table,
                                        plain=plain, backend=backend)[valid]
            name = ("paged_ragged_attention" + ("_grid" if backend == "grid" else "")
                    + ("_int8" if kv_quantize else "") + ("_latent" if cfg.mla else ""))
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
    logits (the MoE fixtures' golden logits likewise), and the engine
    (``--model-name auto``, or the fixture's preset) the greedy tokens."""
    report = {}
    for name, (how, backends) in HF_FIXTURES.items():
        path = os.path.join(FIXTURES, name)
        golden = np.load(os.path.join(path, "golden.npz"))
        prompt, want = golden["prompt"].tolist(), golden["greedy"].tolist()
        cfg = config_from_hf(path) if how == "auto" else get_config_preset(how)
        model = Llama(cfg, torch.float32, "cuda", seed=None)
        model.load_state_dict(load_checkpoint(path, cfg, torch.float32, "cuda"))
        last = torch.from_numpy(golden["last_logits"]).to("cuda")
        row = {}
        for backend in backends:
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
                model=how, checkpoint=path, dtype=torch.float32, device="cuda",
                page_size=4, num_pages=64, max_pages_per_seq=16, max_batch_size=2,
                paged_backend=backend,
            ), model_cfg=None if how == "auto" else cfg)
            got = eng.generate([prompt], SamplingParams(max_tokens=len(want)))[0]
            check(got == want, f"{name} {backend}: greedy {got} != the golden {want}")
            row[backend] = {"last_logits_max_err": err, "greedy_equal": True}
            del eng
        report[name] = row
    return report


# -- phase 6: the decode graph against the eager step -----------------------------
# (model, paged backend, quantize, kv_quantize, layers: None = the model's
# depth) of each replay-vs-eager check.
DECODE_GRAPH = (
    ("bench-8b", "dma", "", "", None),
    ("bench-8b", "dma", "int8", "int8", None),
    ("qwen2.5-7b-instruct", "grid", "", "", None),
    # The MoE scan and the latent kernels inside the captured graphs.
    ("deepseek-v2-lite", "dma", "", "", 2),
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
    for name, backend, quantize, kv_quantize, layers in DECODE_GRAPH:
        cfg = get_config_preset(name)
        if layers is not None:
            cfg = replace(cfg, name=f"{name}-{layers}l", num_layers=layers)
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
        label = f"{cfg.name} {backend}, weights {quantize or 'bf16'}, kv {kv_quantize or 'bf16'}"
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


# -- phase 6b: the JAX engine's default serve loop -----------------------------
# (paged backend, dtype, quantize, kv_quantize, layers) of each loop check,
# at bench-8b width. Tokens are compared across loops that compute them
# through different kernels (a forced run's successor through the ragged
# kernel at q_len > 1, where the reference loop takes the decode kernel):
# f32, where those kernels differ by rounding alone, far under a greedy
# argmax's margins, at 2 layers. The bf16 run, at full depth, reports how far
# the two loops' greedy tokens agree, unchecked, and what each loop's batch
# takes where the ticks are device-bound.
SERVE_LOOP = (
    ("dma", torch.float32, "", "", 2),
    ("grid", torch.float32, "", "", 2),
    ("dma", torch.float32, "int8", "int8", 2),
    ("dma", torch.bfloat16, "", "", BENCH_8B.num_layers),
)
# The synchronous loop the default one is held to.
REFERENCE_LOOP = dict(async_depth=1, pipeline_depth=0, grammar_ffwd=False)
TOOLPROMPT_RF = {"type": "json_schema",
                 "json_schema": {"name": "toolprompt", "schema": TOOLPROMPT_SCHEMA}}
# The ragged kernel at the fast-forward appends' shapes: q_len 2-13 (a forced
# run of up to 12 and its anchor token) deep in a cached sequence, bucket 16.
FFWD_STARTS = [200, 731, 1024, 1999, 2500, 3071, 3600, 4000]
FFWD_Q_LENS = [2, 13, 5, 9, 3, 12, 7, 13]


def loop_batch(stack: ServingStack, bodies: list[dict]) -> list[dict]:
    with ThreadPoolExecutor(len(bodies)) as ex:
        return list(ex.map(lambda b: stack.chat_completion(dict(b)), bodies))


def loop_run(engine: Engine, bodies: list[dict], label: str) -> dict:
    """``bodies`` as one concurrent batch through a ServingStack over the
    warmed ``engine``: the replies (text, finish reason, completion
    tokens), the loop's counts over the batch, the allocator afterwards."""
    stack = ServingStack(engine)
    try:
        was = dict(skipped=obs.FFWD_SKIPPED_DISPATCHES.value(),
                   compiles=obs.POST_WARMUP_COMPILES.value(),
                   overshoot=obs.ASYNC_OVERSHOOT_TOKENS.value(),
                   routes=routes(engine), counts=(engine.async_ticks, engine.ffwd_dispatches,
                                                  engine.ffwd_tokens, engine.pipelined_blocks))
        get_perf_stats().reset()
        t0 = time.perf_counter()
        replies = loop_batch(stack, bodies)
        wall = time.perf_counter() - t0
        perf = get_perf_stats().get_stats()
    finally:
        stack.close()
    with engine.lock:
        engine.drain()
    acct = engine.alloc.accounting()
    replays, eager_steps, mixed_replays, eager_ticks = (
        n - w for n, w in zip(routes(engine), was["routes"]))
    async_ticks, ffwd, ffwd_tokens, pipelined = (
        n - w for n, w in zip((engine.async_ticks, engine.ffwd_dispatches, engine.ffwd_tokens,
                               engine.pipelined_blocks), was["counts"]))
    check(eager_steps == eager_ticks == 0 and replays > 0 and mixed_replays > 0,
          f"{label}: routes {routes(engine)}")
    check(obs.POST_WARMUP_COMPILES.value() == was["compiles"],
          f"{label}: a capture after warmup")
    check(acct["owned"] == 0 and acct["free"] + acct["trie"] == acct["total"],
          f"{label}: pages after the batch {acct}")
    return {
        "replies": [(r["choices"][0]["message"]["content"], r["choices"][0]["finish_reason"],
                     r["usage"]["completion_tokens"]) for r in replies],
        "wall_s": wall,
        "ttft_p50_s": statistics.median(r["ttft_s"] for r in replies),
        "skipped_dispatches": obs.FFWD_SKIPPED_DISPATCHES.value() - was["skipped"],
        "overshoot_tokens": obs.ASYNC_OVERSHOOT_TOKENS.value() - was["overshoot"],
        "async_ticks": async_ticks, "ffwd_dispatches": ffwd, "ffwd_tokens": ffwd_tokens,
        "pipelined_blocks": pipelined, "decode_replays": replays,
        "mixed_replays": mixed_replays, "pages": acct,
        # Host ms by engine stage over the batch (count, mean, p50).
        "host_ms": {k.removeprefix("engine."): [v["count"], v["avg"], v["p50"]]
                    for k, v in perf.items() if k.startswith("engine.") and k != "engine.ttft"
                    and v.get("unit") == "ms" and v["count"]},
    }


def provider_check(stack: ServingStack, name: str) -> dict:
    """One greedy completion through the port's ``ChatClient`` on
    ``cuda://<name>`` (``stack`` installed under ``name``) against the same
    request over HTTP to a server on the same stack."""
    from opsagent_tpu_torch.llm.client import ChatClient
    from opsagent_tpu_torch.serving import api

    messages = [{"role": "user", "content": "which pods restart in kube-system?"}]
    body = {"model": name, "messages": messages, "max_tokens": 24, "temperature": 0}
    server = make_server(stack, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    api.install_stack(name, stack)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/chat/completions",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            http_reply = json.loads(r.read())
        reply = ChatClient().chat_completion(f"cuda://{name}", messages, max_tokens=24,
                                             temperature=0)
    finally:
        api.uninstall_stack(name)
        server.shutdown()
        server.server_close()
        stack.close()
        thread.join(timeout=30)
    check(reply["choices"] == http_reply["choices"] and reply["usage"] == http_reply["usage"],
          f"cuda://{name}: {reply['choices']} != HTTP {http_reply['choices']}")
    return {"content": reply["choices"][0]["message"]["content"],
            "completion_tokens": reply["usage"]["completion_tokens"]}


def restart_check(factory, want: list[int], prompt: list[int]) -> dict:
    """A stack over ``factory()``'s engine, warmed; once its request has
    decoded a token, every block of that engine raises (a lost device):
    the scheduler rebuilds the engine through ``factory``, warms it up
    and re-admits the request, which completes with ``want``."""
    engine = factory()
    engine.warmup()
    stack = ServingStack(engine, engine_factory=factory)
    sched = stack.scheduler
    try:
        req = sched.submit(Request(list(prompt), SamplingParams(max_tokens=len(want))))
        # Sabotaged within milliseconds of the first token: the request has
        # hundreds of tokens to go.
        deadline = time.time() + 120
        while time.time() < deadline:
            sids = list(sched._running)
            if sids and engine.sequences.get(sids[0]) is not None \
                    and engine.sequences[sids[0]].tokens:
                break
            time.sleep(0.002)

        def lost(*a, **k):
            raise RuntimeError("device runtime lost")

        engine.step_block = lost
        check(req.done.wait(300), "restart: the request never finished")
    finally:
        stack.close()
    check(not req.error and req.tokens == want and sched._restarts == 1
          and sched.engine is not engine and sched.engine._warm,
          f"restart: error {req.error!r}, {sched._restarts} restarts, tokens "
          f"{req.tokens} != {want}")
    out = {"restarts": sched._restarts, "salvaged_tokens": len(req.generated_prefix),
           "tokens": len(req.tokens)}
    del engine, stack, sched
    return out


def ffwd_shape_kernels(seed: int) -> dict:
    """The ragged kernel, both forms, bf16 and int8 pages, at the
    fast-forward appends' shapes (bench-8b widths, bucket 16, q_len 2-13,
    starts 200-4000) against its plain version; the bf16 pages timed by
    graph replay with their bound and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    c = make_case(gen, 8, 16, 32, 8, 128, 16, FFWD_STARTS, FFWD_Q_LENS, torch.bfloat16)
    out = {}
    for suffix, case in (("", c), ("_int8", quantize_case(c))):
        for form in ("", "_grid"):
            timed = not suffix
            if timed:
                case["bound"] = attention_bound_ms(case, 2)
                case["sdpa"] = ragged_sdpa(case)
            out[f"paged_ragged_attention{form}{suffix}"] = run_kernel_case(
                f"paged_ragged_attention{form}{suffix}", case, torch.bfloat16, timed)
        case.pop("sdpa", None)
    return out


def phase_serve_loop(seed: int, smi: str) -> dict:
    """The JAX engine's default loop against the synchronous one, at
    bench-8b width, each configuration of ``SERVE_LOOP`` one model under
    two engines, both warmed up: defaults
    (``async_depth`` 2, ``pipeline_depth`` 2, grammar fast-forward on) and
    ``REFERENCE_LOOP``. One concurrent greedy batch of three ToolPrompt
    json_schema requests and a plain one: tokens equal (f32), fast-forward
    dispatches skipped (> 0 on the default loop, 0 on the reference), no
    capture after warmup, no page owned after either batch. On the first
    configuration, a ``cuda://`` completion equal to the HTTP reply and a
    sabotaged engine recovered through ``engine_factory``. Then the ragged
    kernel at the fast-forward shapes (``ffwd_shape_kernels``)."""
    gen = torch.Generator().manual_seed(seed)
    letters = "abcdefghijklmnopqrstuvwxyz     .,\n"

    def prompt(n: int) -> str:
        idx = torch.randint(0, len(letters), (n,), generator=gen).tolist()
        return "".join(letters[i] for i in idx)

    # The plain row outlives the constrained ones: while a constrained row
    # runs every row rides the async ticks (fast-forward), after it the
    # plain row decodes in pipelined blocks.
    bodies = [{"model": "bench-8b", "temperature": 0, "max_tokens": n_out,
               "messages": [{"role": "user", "content": prompt(n)}],
               **({"response_format": TOOLPROMPT_RF} if constrained else {})}
              for n, n_out, constrained in ((300, 64, True), (1500, 64, True),
                                            (3000, 64, True), (800, 200, False))]
    report: dict = {"configs": {}}
    reset_launch_counts()
    for i, (backend, dtype, quantize, kv_quantize, layers) in enumerate(SERVE_LOOP):
        cfg = replace(BENCH_8B, num_layers=layers)
        model = Llama(cfg, dtype, "cuda", seed=seed, quantize=quantize)
        tokenizer = ByteTokenizer(cfg.vocab_size)
        # The ToolPrompt FSM's dense tables, built once per tokenizer on the
        # host, before either batch: the first batch to need them would pay
        # the build in its TTFT.
        json_constraint(tokenizer, TOOLPROMPT_SCHEMA).fsm.dense_tables()
        base = EngineConfig(model="bench-8b", dtype=dtype, device="cuda", seed=seed,
                            num_pages=1024, quantize=quantize, kv_quantize=kv_quantize,
                            paged_backend=backend)
        label = (f"serve_loop {backend} {str(dtype)[6:]} weights {quantize or 'unquantized'} "
                 f"kv {kv_quantize or 'unquantized'} layers {layers}")

        def make(**over):
            return Engine(replace(base, **over), model_cfg=cfg, model=model,
                          tokenizer=tokenizer)

        runs, warmup_s = {}, {}
        for name, over in (("default", {}), ("reference", REFERENCE_LOOP)):
            eng = make(**over)
            warmup_s[name] = eng.warmup()
            runs[name] = loop_run(eng, bodies, f"{label} {name}")
            if name == "default" and i == 0:
                provider = provider_check(ServingStack(eng), "bench-8b")
            del eng
        d, r = runs["default"], runs["reference"]
        check(d["skipped_dispatches"] > 0 and d["async_ticks"] > 0 and d["pipelined_blocks"] > 0
              and r["skipped_dispatches"] == r["async_ticks"] == r["pipelined_blocks"] == 0,
              f"{label}: loops {d} / {r}")
        same = [a == b for a, b in zip(d["replies"], r["replies"])]
        if dtype == torch.float32:
            check(all(same), f"{label}: default loop {d['replies']} != reference {r['replies']}")
        constrained = sum(1 for b in bodies if "response_format" in b)
        row = {"warmup_s": warmup_s, "replies_equal": same,
               "skipped_dispatches_per_constrained_reply": d["skipped_dispatches"] / constrained,
               **{f"{k}_{name}": v for name, run in runs.items() for k, v in run.items()
                  if k != "replies"},
               "completion_tokens": [x[2] for x in d["replies"]]}
        if i == 0:
            row["provider"] = provider
            uninterrupted = make(**REFERENCE_LOOP)
            uninterrupted.warmup()   # a capture outside warmup is a serving compile
            prompt_ids = [257] + list(range(40, 140))
            want = uninterrupted.generate([prompt_ids], SamplingParams(max_tokens=256))[0]
            del uninterrupted
            row["restart"] = restart_check(make, want, prompt_ids)
        report["configs"][label] = row
        del model, runs
        gc.collect()
        torch.cuda.empty_cache()
    report["launches"] = launch_counts()
    report["ffwd_shapes"] = {"starts": FFWD_STARTS, "q_lens": FFWD_Q_LENS,
                             "kernels": ffwd_shape_kernels(seed)}
    report["card"] = smi
    return report


# -- phase 6c: the host KV tier ----------------------------------------------------
# Turn-1 prompt lengths: one past a page boundary, so that 16 greedy tokens
# fill the prompt's last page and decoding books no page.
OFFLOAD_SESSIONS = (993, 1793, 2401, 2993)
PRESSURE_SESSIONS = (993, 1393, 1793, 2193, 2593, 2993)
PRESSURE_PAGES = 400         # of the 753 the six prompts need
TURN1 = SamplingParams(max_tokens=16)
TURN2 = SamplingParams(max_tokens=32)
CONT = [10, 257, 33, 44, 55]  # the next turn's new tokens


def random_prompt(gen: torch.Generator, n: int, vocab: int) -> list[int]:
    return [257] + torch.randint(300, vocab, (n - 1,), generator=gen).tolist()


def page_bytes(eng: Engine, pages: list[int]) -> dict[str, torch.Tensor]:
    return {n: leaf[:, pages].clone() for n, leaf in eng.cache.page_leaves().items()}


def synced(fn):
    """(fn's result, host seconds with the card synchronized after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def prefill(eng: Engine, sid: int, upto: int | None = None) -> None:
    """Mixed ticks of the sequence's prompt until ``upto`` of its tokens
    are in cache (all of them and its first token when None)."""
    while sid in eng._prefilling and (upto is None or eng._prefilling[sid] < upto):
        eng.step_mixed([], {sid: eng.cfg.mixed_buckets[-1]})


def finish_turn(eng: Engine, sid: int) -> list[int]:
    while not eng.sequences[sid].done:
        eng.step_block([sid])
    eng.drain()
    return eng.finish(sid)


def park_round_trip(eng: Engine, ref: Engine, cold: Engine | None, prompts, label: str) -> dict:
    """Turn 1 of ``prompts`` on ``eng`` (host tier on) and ``ref`` (off),
    equal; the longest session's history parked to host RAM on ``eng``
    (spill timed), then its turn 2 admitted: the restored pages hold the
    pre-park bytes, and the continuation equals ``ref``'s, whose turn 2
    hits its HBM trie. With ``cold`` (an engine holding none of it) the
    same turn 2 re-prefilled: its prefill of the restored tokens and its
    TTFT beside the restore's."""
    outs = eng.generate(prompts, TURN1)
    check(outs == ref.generate(prompts, TURN1), f"{label}: turn 1 differs")
    hist = prompts[-1] + outs[-1][:-1]
    P = eng.cfg.page_size
    pages = eng.alloc.match_prefix(hist)
    check(len(pages) == len(hist) // P, f"{label}: {len(pages)} trie pages")
    before = page_bytes(eng, pages)
    nbytes = sum(t.numel() * t.element_size() for t in before.values())
    parked, dispatch_s = synced(lambda: eng.park_chain(hist))
    landed, land_s = synced(eng.offload_flush)
    spill_s = dispatch_s + land_s
    check(parked == len(pages) * P and landed == len(pages), f"{label}: parked {parked}, "
          f"landed {landed} of {len(pages)} pages")
    prompt2 = hist + CONT
    ttft_t0 = time.perf_counter()
    sid, restore_s = synced(lambda: eng.begin_request(prompt2, TURN2))
    restored = eng._prefilling[sid]
    check(restored == len(pages) * P, f"{label}: restored {restored} tokens")
    after = page_bytes(eng, eng.alloc.pages_of(sid)[: len(pages)])
    check(all(torch.equal(before[n], after[n]) for n in before),
          f"{label}: restored pages differ from the parked ones")
    prefill(eng, sid)
    torch.cuda.synchronize()
    ttft_restored = time.perf_counter() - ttft_t0
    got = finish_turn(eng, sid)
    rsid = ref.begin_request(prompt2, TURN2)
    prefill(ref, rsid)
    want = finish_turn(ref, rsid)
    check(got == want, f"{label}: parked continuation {got} != never parked {want}")
    row = {"tokens_parked": parked, "pages": len(pages), "bytes": nbytes,
           "spill_ms": spill_s * 1e3, "spill_dispatch_ms": dispatch_s * 1e3,
           "spill_land_ms": land_s * 1e3, "spill_gbps": nbytes / spill_s / 1e9,
           "restore_ms": restore_s * 1e3, "restore_gbps": nbytes / restore_s / 1e9,
           "ttft_restored_ms": ttft_restored * 1e3, "continuation_equal": True}
    if cold is not None:
        t0 = time.perf_counter()
        csid, _ = synced(lambda: cold.begin_request(prompt2, TURN2))
        _, reprefill_s = synced(lambda: prefill(cold, csid, upto=restored))
        # Ticks of up to a bucket each: the last one may run to the end of
        # the prompt (and sample its first token).
        row["reprefill_tokens"] = cold._prefilling.get(csid, len(prompt2))
        row["reprefill_ms"] = reprefill_s * 1e3
        prefill(cold, csid)
        torch.cuda.synchronize()
        row["ttft_reprefill_ms"] = (time.perf_counter() - t0) * 1e3
        # Information: the cold prefill runs other chunks than the trie
        # hit's, so in bf16 its tokens may differ.
        row["reprefill_continuation_equal"] = finish_turn(cold, csid) == want
        row["restore_vs_reprefill"] = row["reprefill_ms"] / row["restore_ms"]
    return row


def loop_bodies(gen: torch.Generator) -> list[dict]:
    letters = "abcdefghijklmnopqrstuvwxyz     .,\n"
    return [{"model": "bench-8b", "temperature": 0, "max_tokens": 64,
             "messages": [{"role": "user", "content": "".join(
                 letters[i] for i in torch.randint(0, len(letters), (n,), generator=gen))}]}
            for n in (1000, 1800, 2400, 3000)]


def pressure_run(engine: Engine, prompts: list[list[int]]) -> list[list[int]]:
    stack = ServingStack(engine)
    try:
        reqs = [stack.scheduler.submit(Request(list(p), TURN1)) for p in prompts]
        for r in reqs:
            check(r.done.wait(600) and not r.error, f"pressure: {r.error!r}")
    finally:
        stack.close()
    return [r.tokens for r in reqs]


def phase_offload(seed: int, smi: str) -> dict:
    """The host KV tier at bench-8b width: a park round trip at full depth
    in bf16 pages (timed: spill and restore GB/s, restore against the
    re-prefill of the same tokens, TTFT restored against re-prefilled) and
    in int8 pages; the serve loop's host ms with the tier on and off; then,
    at 2 layers in f32, pressure parking of six concurrent sessions in too
    few pages (every reply equal to the never-parked run's) and decode
    replayed after a restore against eager; and the copies of DeepSeek-V2-
    Lite's latent pages. Launches counted over all of it."""
    gen = torch.Generator().manual_seed(seed + 17)
    report: dict = {"card": smi}
    reset_launch_counts()
    model = Llama(BENCH_8B, torch.bfloat16, "cuda", seed=seed)
    prompts = [random_prompt(gen, n, BENCH_8B.vocab_size) for n in OFFLOAD_SESSIONS]
    base = EngineConfig(model="bench-8b", device="cuda", seed=seed, num_pages=1024)

    def make(**over):
        eng = Engine(replace(base, **over), model_cfg=BENCH_8B, model=model)
        eng.warmup()
        return eng

    compiles = obs.POST_WARMUP_COMPILES.value()
    fallbacks = obs.OFFLOAD_RESTORE_FALLBACKS.value()
    eng, ref, cold = make(offload=True), make(), make()
    # An untimed round trip first: the pinned host blocks are allocated
    # once, by the first copies of their size.
    park_round_trip(eng, ref, None, prompts[:3], "offload bf16 warm")
    report["bf16"] = park_round_trip(eng, ref, cold, prompts, "offload bf16")
    report["host_ms_tier_on"] = loop_run(eng, loop_bodies(torch.Generator().manual_seed(seed)),
                                         "offload tier on")["host_ms"]
    report["host_ms_tier_off"] = loop_run(ref, loop_bodies(torch.Generator().manual_seed(seed)),
                                          "offload tier off")["host_ms"]
    del eng, ref, cold
    eng, ref = make(offload=True, kv_quantize="int8"), make(kv_quantize="int8")
    report["int8"] = park_round_trip(eng, ref, None, prompts[1:], "offload int8 kv")
    del eng, ref, model
    gc.collect()
    torch.cuda.empty_cache()

    cut = replace(BENCH_8B, num_layers=2)
    model = Llama(cut, torch.float32, "cuda", seed=seed)
    prompts = [random_prompt(gen, n, cut.vocab_size) for n in PRESSURE_SESSIONS]
    base = EngineConfig(model="bench-8b", dtype=torch.float32, device="cuda", seed=seed,
                        num_pages=1024)
    parks = obs.OFFLOAD_PARKS.value(trigger="pressure")
    tight = make(offload=True, num_pages=PRESSURE_PAGES)
    got = pressure_run(tight, prompts)
    want = pressure_run(make(), prompts)
    report["pressure"] = {
        "pages": PRESSURE_PAGES, "prompt_tokens": list(PRESSURE_SESSIONS),
        "parks": obs.OFFLOAD_PARKS.value(trigger="pressure") - parks,
        "restored_tokens": tight.offload.restored_tokens,
        "replies_equal": got == want,
    }
    check(report["pressure"]["parks"] >= 1 and tight.offload.restored_tokens > 0,
          f"pressure parking never fired: {report['pressure']}")
    check(got == want, "pressure: a parked session's reply differs from the never-parked run's")
    del tight

    runs = []
    for replay in (True, False):
        eng = make(offload=True, cuda_graphs=replay)
        sid = eng.add_request(prompts[2], TURN1)
        hist = prompts[2] + finish_turn(eng, sid)[:-1]
        check(eng.park_chain(hist) > 0, "replay: nothing parked")
        sid = eng.add_request(hist + CONT, TURN2)
        check(eng.offload.restored_pages == eng.offload.spilled_pages > 0,
              f"replay: restored {eng.offload.restored_pages} pages")
        tokens = finish_turn(eng, sid)
        runs.append((tokens, [t.clone() for t in cache_bytes(eng.cache)], routes(eng)))
        del eng
    (gt, gc_, groutes), (et, ec, eroutes) = runs
    check(gt == et and all(torch.equal(a, b) for a, b in zip(gc_, ec)),
          "replay after a restore differs from eager")
    check(groutes[1] == groutes[3] == 0 and eroutes[0] == eroutes[2] == 0,
          f"replay routes {groutes} / eager {eroutes}")
    report["replay_after_restore"] = {"tokens_equal": True, "cache_equal": True,
                                      "routes_replayed": groutes, "routes_eager": eroutes}
    del runs, model
    gc.collect()
    torch.cuda.empty_cache()

    # The latent layout at DeepSeek-V2-Lite's page shape.
    lgen = torch.Generator().manual_seed(seed + 18)
    cache = PagedKVCache(DEEPSEEK_V2_LITE, 64, 16, torch.bfloat16, torch.device("cuda"))
    for buf in cache.buffers():
        buf.copy_(torch.randn(buf.shape, generator=lgen))
    copier = PageCopyEngine(copy_pages=8)
    copier.warm(cache)
    leaves = cache.page_leaves()
    for pages in ([3], list(range(8, 16)), [5, 9, 5, 30, 41]):
        before = {n: leaf.clone() for n, leaf in leaves.items()}
        scratch = [b[-1].clone() for b in cache.buffers()]
        copier.dispatch_gather(cache, pages, list(range(len(pages))))
        trees = [t for _, t in copier.flush()]
        check(all(torch.equal(t[n], before[n][:, p].cpu())
                  for t, p in zip(trees, pages) for n in before), f"latent gather {pages}")
        dst = [63 - i for i in range(len(trees))]
        copier.scatter(cache, dst, trees)
        torch.cuda.synchronize()
        check(all(torch.equal(leaf[:, d].cpu(), t[n])
                  for n, leaf in leaves.items() for d, t in zip(dst, trees)),
              f"latent scatter {pages}")
        check(all(torch.equal(b[-1], x) for b, x in zip(cache.buffers(), scratch)),
              "latent copies wrote the scratch slot")
    report["latent_pages"] = {"layers": DEEPSEEK_V2_LITE.num_layers,
                              "page_bytes": sum(leaf[:, 0].numel() * leaf.element_size()
                                                for leaf in cache.page_leaves().values()),
                              "bit_exact": True}
    del cache, copier, leaves
    check(obs.POST_WARMUP_COMPILES.value() == compiles, "offload: a capture after warmup")
    check(obs.OFFLOAD_RESTORE_FALLBACKS.value() == fallbacks, "offload: a restore_reprefill")
    report["launches"] = launch_counts()
    for name in expected_kernels("dma", "", "int8") | expected_kernels("dma", "", ""):
        check(report["launches"][name] > 0, f"offload: {name} never launched")
    return report


# -- phase 6d: engine snapshots ------------------------------------------------------
SNAPSHOT_LAYERS = 8
SNAPSHOT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "chip_smoke_snapshot")


def snapshot_prompt() -> list[int]:
    return [257] + list(range(300, 1800))


def phase_snapshot(seed: int, smi: str) -> dict:
    """bench-8b at full width and ``SNAPSHOT_LAYERS`` layers (at full depth
    8.6 GB of leaves, whose write and digests would dominate the run) with
    int8 weights and int8 KV: ``snapshot create`` of a
    warmed engine, ``verify``, and in a fresh process (its kernel directory
    empty) ``Engine.from_snapshot`` with warmup and one greedy request: the
    tokens equal the source engine's and no nvcc runs (the snapshot's
    libraries pre-seeded)."""
    cfg = replace(BENCH_8B, num_layers=SNAPSHOT_LAYERS)
    reset_launch_counts()
    eng = Engine(EngineConfig(model="bench-8b", device="cuda", seed=seed, quantize="int8",
                              kv_quantize="int8", num_pages=512), model_cfg=cfg)
    eng.warmup()
    want = eng.generate([snapshot_prompt()], TURN2)[0]
    launches = launch_counts()
    kernels = os.path.join(os.path.dirname(SNAPSHOT_DIR), "chip_smoke_kernels")
    shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    shutil.rmtree(kernels, ignore_errors=True)
    try:
        man, write_s = synced(lambda: eng.snapshot(SNAPSHOT_DIR))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rep = verify_snapshot(SNAPSHOT_DIR)
        verify_s = time.perf_counter() - t0
        check(rep["ok"], f"snapshot verify: {rep['errors']}")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--restore-snapshot", SNAPSHOT_DIR],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "OPSAGENT_KERNEL_DIR": kernels})
        process_s = time.perf_counter() - t0
        check(child.returncode == 0, f"snapshot restore process failed:\n{child.stderr[-4000:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
        shutil.rmtree(kernels, ignore_errors=True)
    check(got["tokens"] == want, f"restored greedy {got['tokens']} != source {want}")
    check(got["cache_misses"] == 0 and got["cache_hits"] > 0
          and got["preseeded"] == man["compile_cache"]["entries"] > 0,
          f"snapshot restore built kernels: {got}")
    for name, n in got.pop("launches").items():
        launches[name] += n
    for name in expected_kernels("dma", "int8", "int8"):
        check(launches[name] > 0, f"snapshot: {name} never launched")
    return {"card": smi, "layers": SNAPSHOT_LAYERS, "write_s": write_s, "verify_s": verify_s,
            "weights_bytes": sum(r["nbytes"] for r in man["leaves"]),
            "leaves": len(man["leaves"]), "kernel_libraries": man["compile_cache"]["entries"],
            "kernel_bytes": man["compile_cache"]["bytes"], "restore_process_s": process_s,
            **got, "tokens": len(want), "tokens_equal": True, "launches": launches}


def snapshot_child(path: str) -> int:
    """The restore side of ``phase_snapshot``, in its own process: restore
    with warmup, one greedy request; prints its tokens, seconds, the kernel
    build events and launches as one JSON line."""
    if not torch.cuda.is_available():
        return 1
    reset_launch_counts()
    t0 = time.perf_counter()
    eng = Engine.from_snapshot(path, warmup=True)
    restore_s = time.perf_counter() - t0
    sid = eng.begin_request(snapshot_prompt(), TURN2)
    prefill(eng, sid)
    torch.cuda.synchronize()
    first_token_s = time.perf_counter() - t0
    tokens = finish_turn(eng, sid)
    emit({"tokens": tokens, "restore_s": restore_s, "restore_to_first_token_s": first_token_s,
          "init": eng.init_stats,
          "cache_misses": obs.COMPILE_CACHE_EVENTS.value(event="cache_misses"),
          "cache_hits": obs.COMPILE_CACHE_EVENTS.value(event="cache_hits"),
          "preseeded": eng.init_stats["kernel_cache_preseeded"],
          "launches": launch_counts()})
    return 0


# -- phase 7: serving at full width -------------------------------------------
KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names, spaces and "(int)" removed)
    # The latent kernels first: their names hold the dma groups' keys.
    ("paged_ragged_attention_latent", ("latent_ragged",)),
    ("paged_decode_attention_latent", ("latent_decode",)),
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


def expected_kernels(backend: str, quantize: str, kv_quantize: str,
                     latent: bool = False) -> set[str]:
    """The kernels a serve run of this configuration must launch; it must
    launch no other. ``latent``: an MLA model's latent cache (the dma
    kernels' latent instances)."""
    form = "_grid" if backend == "grid" else ""
    suffix = "_int8" if kv_quantize else ""
    names = {f"paged_ragged_attention{form}{suffix}", f"paged_decode_attention{form}{suffix}"}
    if latent:
        names = set(LATENT_KERNELS)
    if quantize:
        names.add(f"quant_matmul_{quantize}")
    return names


class TickClock:
    """Host wall time of the engine's ticks: the engine instance's
    ``step_block``, ``step_mixed``, ``step_mixed_async`` and ``ffwd_step``
    wrapped with ``time.perf_counter`` (a pipelined block or an async tick
    returns with the tokens of earlier ones), decode steps counted through
    the engine module's ``decode_block`` calls (the sum of ``n_steps``),
    and mixed ticks as the ``step_mixed`` calls that ran a forward, the
    async ticks enqueued and the fast-forward appends (every one a mixed
    graph's replay). Keeps the arguments of the block with the most active
    rows that were all seated from the host, for ``decode_device_ms``."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.reset()
        self._decode_block = engine_module.decode_block
        wrapped = {name: getattr(engine, name)
                   for name in ("step_block", "step_mixed", "step_mixed_async", "ffwd_step")}

        def timed(name, attr):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    out = wrapped[name](*args, **kwargs)
                finally:
                    setattr(self, attr, getattr(self, attr) + time.perf_counter() - t0)
                if name == "step_mixed":
                    self.sync_ticks += any(out)
                return out
            return run

        def counted_decode_block(state, step, tokens, write_at, active, budgets,
                                 page_table, *args, n_steps, fsm, override=None):
            self.decode_steps += n_steps
            self.decode_blocks += 1
            rows = active & (budgets > 0)
            n = int(rows.sum())
            # A carried row's host arrays hold no token or offset.
            seated = override is None or bool(np.all(override[rows]))
            if seated and n > self._active:
                self._active = n
                self.block_args = (tokens.copy(), write_at.copy(), active.copy(),
                                   page_table.copy(), fsm.copy())
            return self._decode_block(state, step, tokens, write_at, active, budgets,
                                      page_table, *args, n_steps=n_steps, fsm=fsm,
                                      override=override)

        for name in wrapped:
            setattr(engine, name, timed(name, "block_s" if name == "step_block" else "mixed_s"))
        engine_module.decode_block = counted_decode_block

    def reset(self) -> None:
        self.block_s = self.mixed_s = 0.0
        self.decode_steps = self.decode_blocks = self.sync_ticks = 0
        self.block_args = None
        self._active = -1
        eng = self.engine
        self._base = (eng.async_ticks, eng.ffwd_dispatches, eng.ffwd_tokens,
                      eng.pipelined_blocks)

    def close(self) -> None:
        engine_module.decode_block = self._decode_block

    def fields(self) -> dict:
        eng = self.engine
        async_ticks, ffwd, ffwd_tokens, pipelined = (
            n - was for n, was in zip((eng.async_ticks, eng.ffwd_dispatches,
                                       eng.ffwd_tokens, eng.pipelined_blocks), self._base))
        mixed = self.sync_ticks + async_ticks + ffwd
        return {
            "decode_blocks": self.decode_blocks,
            "pipelined_blocks": pipelined,
            "decode_steps": self.decode_steps,
            "decode_wall_ms_per_step": self.block_s * 1e3 / max(self.decode_steps, 1),
            "mixed_ticks": mixed,
            "mixed_sync_ticks": self.sync_ticks,
            "mixed_async_ticks": async_ticks,
            "ffwd_dispatches": ffwd,
            "ffwd_tokens": ffwd_tokens,
            "mixed_wall_ms_per_tick": self.mixed_s * 1e3 / max(mixed, 1),
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
                      model: str, backend: str, latent: bool) -> dict:
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
    expected = expected_kernels(backend, "", "", latent)
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


# -- phase 7: the serve's own observability ------------------------------------
# The exposition grammar of tests/test_metrics_conformance.py (the script
# cannot import the test): line syntax, one TYPE per family before its
# samples, each family's samples contiguous, histogram buckets cumulative up
# to +Inf == _count.
METRIC_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
LABEL_NAME = r"[a-zA-Z_][a-zA-Z0-9_]*"
LABEL_VALUE = r'"(?:[^"\\\n]|\\\\|\\"|\\n)*"'
LABELS = rf"\{{{LABEL_NAME}={LABEL_VALUE}(?:,{LABEL_NAME}={LABEL_VALUE})*,?\}}"
SAMPLE_VALUE = r"(?:[+-]?(?:\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|Inf)|NaN)"
SAMPLE_RE = re.compile(rf"^({METRIC_NAME})({LABELS})? ({SAMPLE_VALUE})(?: [+-]?\d+)?$")
HELP_RE = re.compile(rf"^# HELP ({METRIC_NAME}) .*$")
TYPE_RE = re.compile(rf"^# TYPE ({METRIC_NAME}) (counter|gauge|histogram|summary|untyped)$")
# Anomalies a serve may raise: a request whose first token came past the
# TTFT line (OPSAGENT_SLO_TTFT_MS, 500 ms) and the SLO breach that a scrape
# then evaluates. A post-warmup compile or a failed request is a failure.
SERVE_ANOMALIES = {"ttft_breach", "slo_breach"}


def parse_exposition(text: str) -> dict[str, float]:
    """The samples of a ``/metrics`` document, by ``name{labels}``, after
    checking it against the exposition grammar (``check`` fails on the
    first violation)."""
    check(text.endswith("\n"), "exposition: no final newline")
    types: dict[str, str] = {}
    samples: dict[str, float] = {}
    order: list[str] = []
    for ln in text.split("\n")[:-1]:
        if ln.startswith("# HELP "):
            check(bool(HELP_RE.match(ln)), f"exposition: bad HELP line {ln!r}")
            continue
        if ln.startswith("# TYPE "):
            m = TYPE_RE.match(ln)
            check(bool(m) and m.group(1) not in types, f"exposition: bad TYPE line {ln!r}")
            types[m.group(1)] = m.group(2)
            continue
        m = SAMPLE_RE.match(ln)
        check(bool(m), f"exposition: bad sample line {ln!r}")
        name, labels = m.group(1), m.group(2) or ""
        h = re.search(r"_(bucket|sum|count)$", name)
        fam = name[:h.start()] if h and types.get(name[:h.start()]) == "histogram" else name
        check(fam in types, f"exposition: {name} before its TYPE")
        order.append(fam)
        check(name + labels not in samples, f"exposition: duplicate sample {ln!r}")
        samples[name + labels] = float(m.group(3).replace("Inf", "inf"))
    closed, prev = set(), None
    for fam in order:
        if fam != prev:
            check(fam not in closed, f"exposition: {fam} interleaved with other families")
            if prev is not None:
                closed.add(prev)
            prev = fam
    for fam in (f for f, kind in types.items() if kind == "histogram"):
        children: dict[str, list] = {}
        for key, v in samples.items():
            if key.startswith(fam + "_bucket{"):
                le = re.search(rf'le="({SAMPLE_VALUE})"', key).group(1)
                rest = re.sub(rf',?le="{re.escape(le)}"', "", key[len(fam + "_bucket"):])
                children.setdefault("" if rest == "{}" else rest, []).append(
                    (float(le.replace("Inf", "inf")), v))
        for child, series in children.items():
            series.sort()
            counts = [c for _, c in series]
            check(series[-1][0] == math.inf and counts == sorted(counts)
                  and samples.get(f"{fam}_count{child}") == counts[-1]
                  and f"{fam}_sum{child}" in samples,
                  f"exposition: histogram {fam}{child} buckets {series}")
    return samples


def http_get(port: int, path: str, method: str = "GET") -> tuple[int, bytes]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def scrape(port: int) -> dict[str, float]:
    status, text = http_get(port, "/metrics")
    check(status == 200, f"/metrics status {status}")
    return parse_exposition(text.decode())


def span_names(node: dict, out: set | None = None) -> set:
    out = set() if out is None else out
    out.add(node["name"])
    for c in node.get("children", ()):
        span_names(c, out)
    return out


def obs_block(port: int, before: dict, after: dict, replies, ticks: dict, decode_blocks: int,
              t0_wall: float, label: str) -> dict:
    """The serve's ``obs`` block, from its own server over the timed window
    (``before``/``after``: its ``/metrics`` parsed before and after): the
    counters held to the serve's own counts, the attribution at the H100's
    peaks, one reply's trace and timeline, and the flight ring's events of
    the window."""
    def d(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    n = len(replies)
    completion = sum(r["usage"]["completion_tokens"] for _, r in replies)
    prompt = sum(r["usage"]["prompt_tokens"] for _, r in replies)
    counts = {
        "decode_tokens": d("opsagent_decode_tokens_total"),
        "ttft_count": d("opsagent_ttft_seconds_count"),
        "prefill_plus_prefix_hit_tokens": d("opsagent_prefill_tokens_total")
        + d("opsagent_prefix_hit_tokens_total"),
        "block_dispatches": d('opsagent_decode_dispatches_total{kind="block"}'),
        "mixed_dispatches": d('opsagent_decode_dispatches_total{kind="mixed"}'),
        "mixed_async_dispatches": d('opsagent_decode_dispatches_total{kind="mixed_async"}'),
        "ffwd_dispatches": d('opsagent_decode_dispatches_total{kind="ffwd"}'),
        "requests_completed": d('opsagent_engine_requests_total{outcome="completed"}'),
        "post_warmup_compiles": after["opsagent_post_warmup_compiles"],
    }
    want = {"decode_tokens": completion, "ttft_count": n,
            "prefill_plus_prefix_hit_tokens": prompt, "block_dispatches": decode_blocks,
            "mixed_dispatches": ticks["mixed_sync_ticks"],
            "mixed_async_dispatches": ticks["mixed_async_ticks"],
            "ffwd_dispatches": ticks["ffwd_dispatches"], "requests_completed": n,
            "post_warmup_compiles": 0}
    check(counts == want, f"{label}: /metrics over the window {counts} != the serve's {want}")
    mfu = after["opsagent_attr_mfu"]
    hbm = after["opsagent_attr_hbm_utilization"]
    check(0 < mfu <= 1.05 and 0 < hbm <= 1.05,
          f"{label}: attribution mfu {mfu}, hbm utilization {hbm} outside (0, 1.05]")
    bytes_by_kind = {k: d(f'opsagent_attr_bytes_total{{kind="{k}"}}')
                     for k in ("weights", "weights_prefetch", "kv_read", "kv_write", "other")}
    # One reply's trace and timeline: JAX's span names; phases partition
    # the request's wall clock.
    rid = replies[0][1]["id"]
    status, raw = http_get(port, f"/api/trace/{rid}")
    check(status == 200, f"{label}: /api/trace/{rid} status {status}")
    trace = json.loads(raw)
    spans = span_names(trace["root"])
    check({"queue_wait", "generate", "prefill", "decode", "detokenize"} <= spans,
          f"{label}: trace spans {sorted(spans)}")
    status, raw = http_get(port, f"/api/timeline/{rid}")
    check(status == 200, f"{label}: /api/timeline/{rid} status {status}")
    tl = json.loads(raw)
    phase_ms = sum(p["duration_ms"] for p in tl["phases"])
    check(abs(phase_ms - tl["duration_ms"]) <= 0.05 * tl["duration_ms"],
          f"{label}: timeline phases {phase_ms} ms of a {tl['duration_ms']} ms request")
    # The flight ring's events of the window: one dispatch event per tick
    # and block; anomalies only of SERVE_ANOMALIES, one TTFT breach per
    # first token past the line.
    status, raw = http_get(port, "/api/debug/flight")
    check(status == 200, f"{label}: /api/debug/flight status {status}")
    events = [e for e in json.loads(raw)["events"] if e["wall"] >= t0_wall]
    ops = [e["op"] for e in events if e["kind"] == "dispatch"]
    mixed_ops = ticks["mixed_sync_ticks"] + ticks["mixed_async_ticks"]
    check(ops.count("mixed") == mixed_ops and ops.count("decode_block") == decode_blocks
          and ops.count("ffwd") == ticks["ffwd_dispatches"],
          f"{label}: flight dispatch events {ops.count('mixed')} mixed, "
          f"{ops.count('decode_block')} blocks, {ops.count('ffwd')} ffwd")
    reasons = [e["reason"] for e in events if e["kind"] == "anomaly"]
    ttft_line = float(os.environ.get("OPSAGENT_SLO_TTFT_MS", "500"))
    late = sum(e["ttft_ms"] > ttft_line for e in events if e["kind"] == "ttft")
    check(set(reasons) <= SERVE_ANOMALIES and reasons.count("ttft_breach") == late,
          f"{label}: anomalies {reasons}, {late} first tokens past {ttft_line} ms")
    return {
        **counts,
        "attr_mfu": mfu, "attr_hbm_utilization": hbm,
        "attr_model_drift_ratio": after.get("opsagent_attr_model_drift_ratio"),
        "attr_bytes_by_kind": bytes_by_kind,
        "attr_flops": d("opsagent_attr_flops_total"),
        "trace_request_id": rid, "trace_spans": sorted(spans),
        "timeline_ms": tl["duration_ms"], "timeline_phase_ms": phase_ms,
        "goodput": tl["goodput"],
        "flight_dispatch_events": len(ops), "anomalies": reasons,
        "itl_count": d("opsagent_inter_token_latency_seconds_count"),
        "step_host_gap_count": {m: d(f'opsagent_step_host_gap_seconds_count{{mode="{m}"}}')
                                for m in ("sync", "async")},
        "async_commits": d("opsagent_async_commits_total"),
        "async_overlapped_commits": d("opsagent_async_overlapped_commits_total"),
        "async_overshoot_tokens": d("opsagent_async_overshoot_tokens_total"),
    }


def profile_batch(port: int, post, bodies, expected: set[str], logdir: str,
                  clock: TickClock, fresh) -> dict:
    """Four more requests, untimed, with ``POST /api/debug/profile?seconds=2``
    sent as they start: the Chrome trace written under the serve's profile
    directory names the serve's kernels (``expected``, by their CUDA names)
    and the engine's annotations; then ``GET /api/debug/memory`` writes a
    non-empty allocator snapshot. Then four requests of new prompts of the
    timed batch's lengths (``fresh``), for the host wall of a tick and a
    step after a capture (``after_capture``, beside the serve line's
    own)."""
    out: dict = {}
    capture = threading.Thread(target=lambda: out.update(
        profile=http_get(port, "/api/debug/profile?seconds=2", "POST")))
    capture.start()
    time.sleep(0.2)
    with ThreadPoolExecutor(len(bodies)) as ex:
        replies = list(ex.map(post, bodies))
    capture.join(timeout=120)
    status, raw = out["profile"]
    check(status == 200, f"profile capture: {status} {raw[:200]!r}")
    check(all(s == 200 for s, _ in replies), "profile batch: a request failed")
    (path,) = [os.path.join(logdir, f) for f in os.listdir(logdir) if f.startswith("trace-")]
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    flat = {re.sub(r"\(int\)|\s", "", n.lower()) for n in names}
    groups = dict(KERNEL_GROUPS)
    group = {k: "quant_matmul" if k.startswith("quant_matmul") else k.removesuffix("_int8")
             for k in expected}
    missing = [k for k in expected if not any(s in n for s in groups[group[k]] for n in flat)]
    annotations = sorted(n for n in names if n.startswith("engine."))
    check(not missing and {"engine.mixed_step_async", "engine.decode_block"} <= set(annotations),
          f"profile trace: kernels {missing} missing, annotations {annotations}")
    status, raw = http_get(port, "/api/debug/memory")
    check(status == 200, f"/api/debug/memory: {status} {raw[:200]!r}")
    mem = json.loads(raw)["path"]
    with open(mem, "rb") as f:
        snap = pickle.load(f)
    check(os.path.getsize(mem) > 0 and len(snap["segments"]) > 0,
          f"memory snapshot {mem}: {os.path.getsize(mem)} bytes")
    clock.reset()
    with ThreadPoolExecutor(len(fresh)) as ex:
        check(all(s == 200 for s, _ in ex.map(post, fresh)), "batch after the capture failed")
    return {
        "after_capture": {k: v for k, v in clock.fields().items()
                          if k in ("mixed_ticks", "mixed_wall_ms_per_tick",
                                   "decode_steps", "decode_wall_ms_per_step")},"trace_bytes": os.path.getsize(path), "trace_events": len(names),
            "kernels_named": sorted(expected), "annotations": annotations,
            "memory_snapshot_bytes": os.path.getsize(mem),
            "memory_segments": len(snap["segments"])}


def set_loop(engine: Engine, loop: dict) -> None:
    """Switch an idle engine's serving loop (``async_depth``,
    ``pipeline_depth``, ``grammar_ffwd``): the ticks and blocks in flight
    are committed first."""
    with engine.lock:
        engine.drain()
        engine._flush_and_invalidate()
        engine.cfg = replace(engine.cfg, **loop)


def phase_serve(seed: int, smi: str, profile: bool, model: str, backend: str,
                quantize: str, kv_quantize: str) -> dict:
    engine = Engine(EngineConfig(model=model, dtype=torch.bfloat16,
                                 device="cuda", seed=seed, quantize=quantize,
                                 kv_quantize=kv_quantize, paged_backend=backend))
    cfg = get_config_preset(model)
    latent = cfg.mla is not None
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

    fsm_run = profiled = None
    label = f"serve {model} {backend} {quantize or 'bf16'}"
    # The bench-8b dma bf16 serve also runs the profiling routes.
    profiled_serve = (model, backend, quantize) == ("bench-8b", "dma", "")
    if profiled_serve:
        shutil.rmtree(PROFILE_DIR, ignore_errors=True)
        os.environ["OPSAGENT_PROFILE_DIR"] = PROFILE_DIR
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics_before, t0_wall = scrape(port), time.time()
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
        serve_obs = obs_block(port, metrics_before, scrape(port), replies, ticks,
                              ticks["decode_blocks"], t0_wall, label)
        # Information, not a claim: new prompts of the same lengths on the
        # synchronous loop (REFERENCE_LOOP), then the defaults again.
        loop_default = {k: getattr(engine.cfg, k) for k in REFERENCE_LOOP}
        set_loop(engine, REFERENCE_LOOP)
        clock.reset()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as ex:
            depth1 = list(ex.map(post, [{**b, "messages": [{"role": "user", "content": prompt(n)}]}
                                        for b, n in zip(bodies, (300, 800, 1500, 3000))]))
        depth1_wall = time.perf_counter() - t0
        check(all(st == 200 for st, _ in depth1), f"{label}: a depth-1 request failed")
        depth1_ticks = clock.fields()
        set_loop(engine, loop_default)
        # The constrained batch runs on the bf16 serves.
        if not quantize:
            # Keep the timed batch's last largest-bucket tick for
            # mixed_device_ms: the constrained batch runs its own.
            last_tick = engine._mixed[engine.cfg.mixed_buckets[-1]]
            saved = [t.clone() for t in last_tick.buffers()]
            fsm_run = constrained_batch(engine, clock, post,
                                        lambda body: post_stream(port, body), prompt,
                                        model, backend, latent)
            with torch.inference_mode():
                for t, was in zip(last_tick.buffers(), saved):
                    t.copy_(was)
            # No capture after warmup: the constraint tables ride the
            # captured graphs.
            check(obs.POST_WARMUP_COMPILES.value() == 0,
                  f"{label}: a capture after warmup in the constrained batch")
        if profiled_serve:
            profiled = profile_batch(port, post, bodies,
                                     expected_kernels(backend, quantize, kv_quantize),
                                     PROFILE_DIR, clock,
                                     [{**b, "messages": [{"role": "user", "content": prompt(n)}]}
                                      for b, n in zip(bodies, (300, 800, 1500, 3000))])
    finally:
        if profiled_serve:
            os.environ.pop("OPSAGENT_PROFILE_DIR", None)
            shutil.rmtree(PROFILE_DIR, ignore_errors=True)
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
    if model.startswith("qwen") and not quantize:
        emit({"phase": "bpe", "model": model, "paged_backend": backend, "card": smi,
              **bpe_serve(engine)})
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
    expected = expected_kernels(backend, quantize, kv_quantize, latent)
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
        # The decode step's byte floor: every weight streamed once.
        "decode_floor_ms": weights / HBM_BYTES_PER_S * 1e3,
        "decode_device_over_floor": ticks["decode_device_ms_per_step"]
        / (weights / HBM_BYTES_PER_S * 1e3),
        "prompt_tokens": [r["usage"]["prompt_tokens"] for _, r in replies],
        "completion_tokens": completion,
        "wall_s": wall,
        "completion_tok_per_s": completion / wall,
        "ttft_p50_s": statistics.median(r["ttft_s"] for _, r in replies),
        "loop": loop_default,
        "depth1": {
            "loop": REFERENCE_LOOP,
            "completion_tokens": (d1 := sum(r["usage"]["completion_tokens"] for _, r in depth1)),
            "wall_s": depth1_wall, "completion_tok_per_s": d1 / depth1_wall,
            "ttft_p50_s": statistics.median(r["ttft_s"] for _, r in depth1),
            **{k: depth1_ticks[k] for k in ("decode_steps", "mixed_ticks",
                                            "decode_wall_ms_per_step",
                                            "mixed_wall_ms_per_tick")},
        },
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
        "obs": serve_obs,
        **({"profile_capture": profiled} if profiled else {}),
    }

# -- phase 7b: a byte-level-BPE tokenizer on the card ----------------------------------
BPE_SCHEMA = {"type": "object", "properties": {"name": {"enum": ["kubectl", "trivy"]},
                                               "ok": {"type": "boolean"}}}


def bpe_serve(served: Engine) -> dict:
    """One json_schema chat completion over HTTP through ``BPETokenizer``
    on ``tests/fixtures/tiny-bpe`` (ChatML prompt), on an engine over the
    serve's own model (its weights reused), warmed up, steps replayed.
    The reply parses and stops; the FSM is built from the BPE's
    ``token_bytes`` and its tables are the ones loaded; ids past the
    tokenizer's 1,027 (the model's padded vocab) never appear."""
    tok = BPETokenizer(BPE_FIXTURE)
    eng = Engine(replace(served.cfg, num_pages=256), model_cfg=served.model_cfg,
                 model=served.model, tokenizer=tok)
    warmup_s = eng.warmup()
    stack = ServingStack(eng)
    server = make_server(stack, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = {"temperature": 0, "max_tokens": 64,
            "messages": [{"role": "user", "content": "Pick a tool and say if it is ok."}],
            "response_format": {"type": "json_schema",
                                "json_schema": {"name": "pick", "schema": BPE_SCHEMA}}}
    try:
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/chat/completions",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            status, reply = r.status, json.loads(r.read())
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        stack.close()
        thread.join(timeout=30)
    ch = reply["choices"][0]
    text = ch["message"]["content"]
    check(status == 200 and ch["finish_reason"] == "stop", f"bpe: {status} {ch}")
    check(json.loads(text)["name"] in ("kubectl", "trivy"), f"bpe: reply {text!r}")
    con = json_constraint(tok, BPE_SCHEMA)
    check(con.fsm.token_bytes == [tok.token_bytes(i) for i in range(tok.vocab_size)]
          and eng._fsm_loaded is con.fsm, "bpe: FSM not built from the BPE token bytes")
    prompt = apply_chat_template(tok, body["messages"], eng.model_cfg.name)
    check(prompt[0] == tok.encode("<|im_start|>")[0]
          and reply["usage"]["prompt_tokens"] == len(prompt), "bpe: prompt is not ChatML")
    check(eng.decode_eager_steps == eng.mixed_eager_ticks == eng.hosted_steps == 0
          # A constrained row decodes on the async ticks (fast-forward)
          # until it ends: its tokens may come from mixed replays alone.
          and eng.decode_replays + eng.mixed_replays > 0,
          f"bpe: routes {routes(eng)}, {eng.hosted_steps} hosted")
    out = {"reply": text, "prompt_tokens": len(prompt),
           "completion_tokens": reply["usage"]["completion_tokens"],
           "tokenizer_vocab": tok.vocab_size, "model_vocab": eng.model_cfg.vocab_size,
           "warmup_s": warmup_s, "wall_s": wall, "routes": routes(eng)}
    del eng
    return out


# -- phase 8: the rest of the chat API ----------------------------------------------
CHAT_TOOLS = [{"type": "function", "function": {
    "name": "kubectl", "description": "run a kubectl command",
    "parameters": {"type": "object", "properties": {"command": {"type": "string"}}}}},
    {"type": "function", "function": {
        "name": "trivy", "description": "scan an image",
        "parameters": {"type": "object", "properties": {"image": {"type": "string"}}}}}]
# Inside a string the quote wins, after it '}' then ']' wherever the
# grammar allows them: the envelope closes in tens of tokens. The biases
# lie further apart than random weights' logits spread (tests/
# test_tool_choice.py's 100 / 99 / 98 let '}' win inside a string here).
CLOSE_BIAS = {str(ord('"')): 100, str(ord('}')): 60, str(ord(']')): 30}
# The extras batch: four plain greedy rows, then a bias row, a penalty row,
# a logprobs row and one with all three.
EXTRAS_ROWS = (
    SamplingParams(max_tokens=48),
    SamplingParams(max_tokens=48),
    SamplingParams(max_tokens=48),
    SamplingParams(max_tokens=48),
    SamplingParams(max_tokens=48, logit_bias=((ord("e"), 10.0), (ord(" "), 10.0))),
    SamplingParams(max_tokens=48, presence_penalty=1.0, frequency_penalty=1.5),
    SamplingParams(max_tokens=48, logprobs=True, top_logprobs=5),
    SamplingParams(max_tokens=48, logit_bias=((ord("a"), 5.0),), presence_penalty=0.5,
                   frequency_penalty=0.5, logprobs=True, top_logprobs=20),
)


def extras_batch(eng: Engine, prompts: list[list[int]], after_first_block=None) -> dict:
    """``EXTRAS_ROWS`` over ``prompts``: admitted together in mixed ticks
    (rows whose prompt is done decode in the next ones), then blocks until
    every row is done. Returns each row's tokens and logprob entries and
    the first block's length for each row."""
    ids = [eng.begin_request(p, s) for p, s in zip(prompts, EXTRAS_ROWS)]
    while eng._prefilling:
        decode = [i for i in ids if i not in eng._prefilling and not eng.sequences[i].done]
        eng.step_mixed(decode, {i: 128 for i in eng._prefilling})
    first = eng.step_block(ids)
    if after_first_block is not None:
        after_first_block()
    while any(not eng.sequences[i].done for i in ids):
        eng.step_block([i for i in ids if not eng.sequences[i].done])
    lps = [list(eng.sequences[i].logprob_data) for i in ids]
    return {"tokens": [eng.finish(i) for i in ids], "logprobs": lps,
            "first_block": [len(first.get(i, [])) for i in ids]}


def replayed_step_ms(eng: Engine, graph, block_args, extras_row: bool, reps: int = 20) -> float:
    """Median device time of one replay of ``graph`` (a decode step over
    the engine's state) at a serve's block inputs, reloaded before each
    replay (untimed), with row 0's bias, penalties and logprobs loaded
    when ``extras_row``. Raw replays: the launch counters are left alone."""
    tokens, write_at, active, table, fsm = block_args
    B = len(tokens)
    lanes = [None] * B
    if extras_row:
        lanes[0] = Sequence(-1, 1, params=EXTRAS_ROWS[-1], tokens=[1, 2, 3])
    zeros = np.zeros((B,), np.float32)
    budgets = np.full((B,), eng.cfg.decode_block, np.int32)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    with torch.inference_mode():
        for _ in range(reps + 2):
            eng._decode.load(tokens, write_at, active, budgets, table, zeros,
                             zeros.astype(np.int32), zeros + 1, fsm)
            eng._load_extras(lanes)
            torch.cuda.synchronize()
            t0.record()
            graph.replay()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        eng._load_extras([None] * B)
    return statistics.median(times[2:])


def phase_chat_api(seed: int, smi: str, bf16_tol: float) -> dict:
    """bench-8b at full width and depth on the dma kernels, bf16, one model
    under two engines: one replays its steps (warmed up), one runs them
    eagerly through the same kernels. (1) Over HTTP on the replaying
    engine, an ``n`` = 2 greedy request forcing a named ``tool_choice``:
    both choices call that tool with arguments that parse, and are equal.
    (2) ``EXTRAS_ROWS`` as one batch on both engines: greedy tokens equal,
    logprobs within ``bf16_tol`` (the e2e_bf16 phase's bf16 cost), every
    row a full first block. (3) A bias of -100 on a plain row's first
    greedy token moves it. (4) The replaying engine ran no eager step and
    no hosted one. (5) The decode step's device time: the engine's graph
    without the extras (what plain batches replay) and its graph with
    them, an extras row loaded, alternated."""
    cfg = get_config_preset("bench-8b")
    model = Llama(cfg, torch.bfloat16, "cuda", seed=seed)
    tokenizer = ByteTokenizer(cfg.vocab_size)
    engines = {replay: Engine(EngineConfig(model="bench-8b", dtype=torch.bfloat16,
                                           device="cuda", seed=seed, num_pages=1024,
                                           paged_backend="dma", cuda_graphs=replay),
                              model_cfg=cfg, model=model, tokenizer=tokenizer)
               for replay in (True, False)}
    warmup_s = {str(r): e.warmup() for r, e in engines.items()}
    eng = engines[True]
    reset_launch_counts()

    # (1) forced tool calls, n = 2, over HTTP.
    stack = ServingStack(eng)
    server = make_server(stack, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = {"model": "bench-8b", "temperature": 0, "max_tokens": 256, "n": 2,
            "messages": [{"role": "user", "content": "list the pods in kube-system"}],
            "tools": CHAT_TOOLS, "logit_bias": CLOSE_BIAS,
            "tool_choice": {"type": "function", "function": {"name": "kubectl"}}}
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/chat/completions",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            status, reply = r.status, json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        stack.close()
        thread.join(timeout=30)
    choices = reply["choices"]
    check(status == 200 and len(choices) == 2, f"chat_api: tool call {status} {reply}")
    for ch in choices:
        calls = ch["message"].get("tool_calls") or []
        check(ch["finish_reason"] == "tool_calls" and calls
              and calls[0]["function"]["name"] == "kubectl",
              f"chat_api: choice {ch}")
        json.loads(calls[0]["function"]["arguments"])
    check(choices[0]["message"] == choices[1]["message"], f"chat_api: choices differ {choices}")
    tool_call = {"arguments": choices[0]["message"]["tool_calls"][0]["function"]["arguments"],
                 "completion_tokens": reply["usage"]["completion_tokens"],
                 "fsm_loads": eng.fsm_loads, "hosted_steps": eng.hosted_steps}

    # (2) the extras batch, replayed and eager; (5) timed after the
    # replaying engine's first block, with its rows live.
    gen = torch.Generator().manual_seed(seed)
    prompts = [[257] + torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (300, 800, 200, 500, 400, 250, 600, 350)]
    clock = TickClock(eng)
    timing = {}

    def time_step():
        graphs = {"plain": eng._graphs["decode", True, False].graph,
                  "extras_row": eng._graphs["decode", True, True].graph}
        for key in ("plain", "extras_row", "extras_row", "plain"):
            timing.setdefault(key, []).append(replayed_step_ms(
                eng, graphs[key], clock.block_args, key == "extras_row"))

    try:
        before = (*routes(eng), eng.hosted_steps)
        runs = {True: extras_batch(eng, prompts, time_step)}
        after = (*routes(eng), eng.hosted_steps)
    finally:
        clock.close()
    runs[False] = extras_batch(engines[False], prompts)
    got, want = runs[True], runs[False]
    check(got["tokens"] == want["tokens"],
          f"chat_api: replayed extras batch {got['tokens']} != eager {want['tokens']}")
    lp_err = 0.0
    for g_row, w_row in zip(got["logprobs"], want["logprobs"]):
        check(len(g_row) == len(w_row), "chat_api: logprob entries differ in number")
        for g, w in zip(g_row, w_row):
            lp_err = max(lp_err, abs(g["logprob"] - w["logprob"]),
                         *(abs(a[1] - b[1]) for a, b in zip(g["top"], w["top"])))
    check(lp_err <= bf16_tol, f"chat_api: logprobs off by {lp_err} > {bf16_tol}")
    check(all(n == eng.cfg.decode_block for n in got["first_block"]),
          f"chat_api: first block lengths {got['first_block']}")
    check(len(got["logprobs"][6]) == len(got["tokens"][6]) > 0
          and all(len(d["top"]) == 5 for d in got["logprobs"][6]),
          "chat_api: logprobs row entries")
    # (3) a bias of -100 on a plain row's first greedy token.
    first = got["tokens"][0][0]
    moved = eng.generate([prompts[0]], SamplingParams(max_tokens=1,
                                                      logit_bias=((first, -100.0),)))[0][0]
    check(moved != first, f"chat_api: a -100 bias left token {first} in place")
    # (4) no eager step, no hosted one.
    replays, eager_steps, mixed_replays, eager_ticks, hosted = (
        a - b for a, b in zip(after, before))
    check(eng.decode_eager_steps == eng.mixed_eager_ticks == 0 and eng.hosted_steps == 0
          and replays > 0 and mixed_replays > 0,
          f"chat_api: routes {routes(eng)}, {eng.hosted_steps} hosted steps")
    launches = launch_counts()
    for name, n in launches.items():
        check((n > 0) == (name in expected_kernels("dma", "", "")),
              f"chat_api: {name} launched {n} times")
    # The extras graphs were captured by warmup: no capture since.
    check(obs.POST_WARMUP_COMPILES.value() == 0, "chat_api: a capture after warmup")
    med = {k: statistics.median(v) for k, v in timing.items()}
    out = {
        "warmup_s": warmup_s, "tool_call": tool_call,
        "extras_tokens_equal_to_eager": True, "logprobs_max_abs_err": lp_err,
        "logprobs_tol": bf16_tol, "first_block": got["first_block"],
        "forbidden_first_token": first, "moved_to": moved,
        "batch_decode_replays": replays, "batch_mixed_replays": mixed_replays,
        "hosted_steps": eng.hosted_steps, "decode_eager_steps": eng.decode_eager_steps,
        "mixed_eager_ticks": eng.mixed_eager_ticks, "launches": launches,
        "decode_device_ms_per_step": timing,
        "extras_cost_ms": med["extras_row"] - med["plain"],
        "extras_cost_share": med["extras_row"] / med["plain"] - 1,
        "post_warmup_compiles": obs.POST_WARMUP_COMPILES.value(),
    }
    del engines, eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return out



# -- phase 6e: the agent stack ---------------------------------------------------
AGENT_FIXTURE = os.path.join(FIXTURES, "tiny-agent-hf")
# The trained tiny agent's episode (scripts/train_tiny_agent.py's constants).
AGENT_SYS_PROMPT = ("You are a k8s ops agent. Reply with ToolPrompt JSON; use the kubectl "
                    "tool, then give final_answer.")
AGENT_INSTRUCTION = "count namespaces"
AGENT_KUBECTL_CMD = "kubectl get namespaces --no-headers | wc -l"
AGENT_FINAL_ANSWER = "There are 3 namespaces in the cluster."
AGENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_agent")
# The full-width run: the loop's iteration cap and reply budget.
AGENT_FULL_ITERATIONS = 3
AGENT_FULL_TOKENS = 256
AGENT_FULL_INSTRUCTION = "count the namespaces, then list the pods of kube-system"


def agent_run(model: str, system: str, user: str, max_tokens: int, iterations: int,
              conveyor: bool) -> dict:
    """One ReAct episode through the port's own loop (``conveyor``: the
    stream with early tool launches, else the blocking path): the answer,
    the transcript, and the flight ring's events of the run."""
    from opsagent_tpu_torch.agent.react import assistant_with_config

    os.environ["OPSAGENT_CONVEYOR"] = "1" if conveyor else "0"
    obs.flight.get_recorder().reset()
    messages = [{"role": "system", "content": system}, {"role": "user", "content": user}]
    t0 = time.perf_counter()
    answer, history = assistant_with_config(model, messages, max_tokens, False, False,
                                            iterations, "", "")
    return {"answer": answer, "history": history, "wall_s": time.perf_counter() - t0,
            "events": obs.flight.get_recorder().snapshot()}


def agent_turns(events: list[dict]) -> dict:
    """Per model turn of a run, from its flight events: TTFT, and decode
    tokens/s from the first token to the finish; with the tools' time and
    the tokens parked at tool entry or launch."""
    ttft = {e["seq_id"]: e for e in events if e["kind"] == "ttft"}
    turns = []
    for e in events:
        if e["kind"] == "finish" and e["seq_id"] in ttft:
            first = ttft[e["seq_id"]]
            span = e["ts"] - first["ts"]
            turns.append({"ttft_ms": first["ttft_ms"], "tokens": e["tokens"],
                          "decode_tok_s": (e["tokens"] - 1) / span if span > 0 else None,
                          "finish_reason": e["finish_reason"]})
    tools = [e for e in events if e["kind"] == "tool_exec"]
    return {"turns": turns,
            "tool_calls": sum(1 for e in tools if e["phase"] == "exit"),
            "tool_ms": sum(e.get("duration_ms", 0.0) for e in tools if e["phase"] == "exit"),
            "parked_tokens": sum(e.get("parked_tokens", 0) for e in tools
                                 if e["phase"] == "enter")}


def agent_server_check(name: str, ran: list[str]) -> dict:
    """``/login``, then ``POST /api/execute`` on ``cuda://<name>`` through the
    port's agent server (the server's own system prompt): its message, its
    trace's spans and the ``/metrics`` counters against the transcript."""
    from opsagent_tpu_torch.server.app import build_server
    from opsagent_tpu_torch.utils.globalstore import set_global

    set_global("jwtKey", "chip-smoke-key")
    server = build_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def call(path, body=None, token=""):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method="POST" if body is not None else "GET",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json", "X-API-Key": "local",
                     **({"Authorization": f"Bearer {token}"} if token else {})})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    try:
        token = call("/login", {"username": "admin", "password": "novastar"})["token"]
        before = scrape(port)
        n_ran = len(ran)
        reply = call("/api/execute?show-thought=true",
                     {"instructions": AGENT_INSTRUCTION, "currentModel": f"cuda://{name}"},
                     token)
        after = scrape(port)
        trace = call(f"/api/trace/{reply['request_id']}", token=token)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(reply["message"] == AGENT_FINAL_ANSWER,
          f"agent server: message {reply['message']!r}")
    children = trace["root"].get("children", [])
    turns = [c for c in children if c["name"] == "llm_turn"]
    tools = [c for c in children if c["name"] == "tool_exec"]
    engine_spans = set()
    for t in turns:
        for c in t.get("children", []):
            span_names(c, engine_spans)
    check(len(turns) >= 2 and len(tools) == 1
          and {"generate", "prefill", "decode"} <= engine_spans,
          f"agent server: trace {[c['name'] for c in children]}, under llm_turn "
          f"{sorted(engine_spans)}")
    iterations = after["opsagent_agent_iterations_total"] - before.get(
        "opsagent_agent_iterations_total", 0.0)
    key = 'opsagent_agent_tool_calls_total{tool="kubectl",outcome="ok"}'
    tool_ok = after.get(key, 0.0) - before.get(key, 0.0)
    check(iterations == len(turns) and tool_ok == len(tools) == len(reply["tools_history"])
          and ran[n_ran:] == [AGENT_KUBECTL_CMD],
          f"agent server: {iterations} iterations / {len(turns)} turns, {tool_ok} tool calls / "
          f"{reply['tools_history']}, ran {ran[n_ran:]}")
    return {"message": reply["message"], "llm_turns": len(turns), "tool_exec": len(tools),
            "engine_spans": sorted(engine_spans), "iterations_counted": iterations,
            "tool_calls_counted": tool_ok}


def phase_agent(seed: int, smi: str) -> dict:
    """The port's agent stack on the card.

    (a) The trained tiny agent (``tests/fixtures/tiny-agent-hf``, f32, dma
    kernels, installed as ``cuda://tiny-agent``) runs its instruction
    through the port's ``assistant_with_config`` with the replay kubectl
    (refusing any other command): the memorized final answer, the tool run
    once, one transcript with the conveyor on and off and on an engine
    through the plain path (``attn_impl="plain"``, which launches no
    kernel); then through the port's agent server: ``/login``,
    ``/api/execute``, the request's trace and ``/metrics``.
    (b) bench-8b at full width and depth, bf16, dma, random weights: the
    loop (``AGENT_FULL_ITERATIONS``, ``AGENT_FULL_TOKENS``) with every tool
    an in-process stub, on two fresh engines over one model (conveyor on,
    conveyor off): one transcript, every constrained reply a live prefix of
    the ToolPrompt DFA (JSON where it stopped), and its turns' TTFT and
    decode tokens/s, the stub tools' time and the parked tokens."""
    from opsagent_tpu_torch import tools as tool_pkg
    from opsagent_tpu_torch.agent.prompts import REACT_SYSTEM_PROMPT, SUMMARIZE_PROMPT
    from opsagent_tpu_torch.serving import api
    from opsagent_tpu_torch.tools.replay import NAMESPACES_SCRIPT, install_replay_kubectl

    saved_tools = dict(tool_pkg.get_tools())
    saved_env = {k: os.environ.get(k) for k in ("PATH", "OPSAGENT_CONVEYOR")}
    launches = {name: 0 for name in KERNELS}
    report: dict = {}
    try:
        # -- (a) the trained tiny agent ----------------------------------------
        install_replay_kubectl(NAMESPACES_SCRIPT, os.path.join(AGENT_DIR, "bin"))
        replay = tool_pkg.default_registry()["kubectl"]
        ran: list[str] = []

        def kubectl(cmd: str) -> str:
            ran.append(cmd)
            if cmd != AGENT_KUBECTL_CMD:
                raise tool_pkg.ToolError(f"refused: {cmd}")
            return replay(cmd)

        tool_pkg.copilot_tools["kubectl"] = kubectl
        user = f"Here are the instructions: {AGENT_INSTRUCTION}"
        runs = {}
        for impl in ("cuda", "plain"):
            eng = Engine(EngineConfig(model="auto", checkpoint=AGENT_FIXTURE,
                                      tokenizer=AGENT_FIXTURE, dtype=torch.float32,
                                      device="cuda", attn_impl=impl, offload=True))
            eng.warmup()
            stack = ServingStack(eng)
            api.install_stack("tiny-agent", stack)
            try:
                reset_launch_counts()
                for conveyor in ((True, False) if impl == "cuda" else (True,)):
                    n = len(ran)
                    run = agent_run("cuda://tiny-agent", AGENT_SYS_PROMPT, user, 256, 4, conveyor)
                    final = json.loads(run["answer"]).get("final_answer")
                    check(final == AGENT_FINAL_ANSWER and ran[n:] == [AGENT_KUBECTL_CMD],
                          f"tiny agent {impl} conveyor={conveyor}: final {final!r}, "
                          f"ran {ran[n:]}")
                    runs[impl, conveyor] = run
                if impl == "cuda":
                    server = agent_server_check("tiny-agent", ran)
                counts = launch_counts()
            finally:
                api.uninstall_stack("tiny-agent")
                stack.close()
                del eng
            if impl == "cuda":
                for name, c in counts.items():
                    launches[name] += c
                # Every reply decodes under the ToolPrompt schema, on mixed
                # ticks (a constrained row never takes a decode block): the
                # dma ragged kernel carries the whole turn.
                check(counts["paged_ragged_attention"] > 0,
                      f"tiny agent: dma kernels launched {counts}")
            else:
                check(not any(counts.values()), f"tiny agent plain path launched {counts}")
        on, off, plain = runs["cuda", True], runs["cuda", False], runs["plain", True]
        check(on["history"] == off["history"] == plain["history"]
              and on["answer"] == off["answer"] == plain["answer"],
              "tiny agent: transcripts differ between conveyor on, off and the plain path")
        report["tiny_agent"] = {
            "final_answer": AGENT_FINAL_ANSWER, "messages": len(on["history"]),
            "conveyor_on_equals_off": True, "kernels_equal_plain": True,
            "wall_s": {"conveyor": on["wall_s"], "blocking": off["wall_s"],
                       "plain": plain["wall_s"]},
            **agent_turns(on["events"]), "server": server,
        }

        # -- (b) bench-8b at full width --------------------------------------------
        stub_obs = "default\nkube-system\nmonitoring"
        tool_pkg.copilot_tools.clear()
        tool_pkg.copilot_tools.update({name: (lambda arg: stub_obs)
                                       for name in tool_pkg.default_registry()})
        model = Llama(BENCH_8B, torch.bfloat16, "cuda", seed=seed)
        tokenizer = ByteTokenizer(BENCH_8B.vocab_size)
        dfa = json_constraint(tokenizer, TOOLPROMPT_SCHEMA).fsm.dfa
        json_constraint(tokenizer, TOOLPROMPT_SCHEMA).fsm.dense_tables()
        full = {}
        for conveyor in (True, False):
            eng = Engine(EngineConfig(model="bench-8b", dtype=torch.bfloat16, device="cuda",
                                      seed=seed, offload=True),
                         model_cfg=BENCH_8B, model=model, tokenizer=tokenizer)
            warm = eng.warmup()
            stack = ServingStack(eng)
            api.install_stack("bench-8b", stack)
            try:
                reset_launch_counts()
                full[conveyor] = agent_run(
                    "cuda://bench-8b", REACT_SYSTEM_PROMPT,
                    f"Here are the instructions: {AGENT_FULL_INSTRUCTION}", AGENT_FULL_TOKENS,
                    AGENT_FULL_ITERATIONS, conveyor)
                full[conveyor]["warmup_s"] = warm
                for name, c in launch_counts().items():
                    launches[name] += c
            finally:
                api.uninstall_stack("bench-8b")
                stack.close()
                del eng
                gc.collect()
                torch.cuda.empty_cache()
        on, off = full[True], full[False]
        check(on["history"] == off["history"] and on["answer"] == off["answer"],
              "bench-8b agent: transcripts differ with the conveyor on and off")
        replies = 0
        for prev, msg in zip(on["history"], on["history"][1:]):
            if msg["role"] != "assistant" or prev["content"] == SUMMARIZE_PROMPT:
                continue      # the summarization turn decodes unconstrained
            replies += 1
            st = dfa.run(dfa.start, msg["content"].encode())
            check(st >= 0, f"bench-8b agent: a reply leaves the ToolPrompt DFA: "
                           f"{msg['content']!r}")
            if dfa.accept[st]:
                json.loads(msg["content"])
        check(replies > 0, "bench-8b agent: no constrained reply")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        turns = agent_turns(on["events"])
        report["full_width"] = {
            "model": "bench-8b", "layers": BENCH_8B.num_layers, "dtype": "bfloat16",
            "card": smi, "conveyor_on_equals_off": True, "constrained_replies": replies,
            "turn_count": len(turns["turns"]),
            "ttft_ms": [t["ttft_ms"] for t in turns["turns"]],
            "decode_tok_s": [t["decode_tok_s"] for t in turns["turns"]],
            "completion_tokens": [t["tokens"] for t in turns["turns"]],
            "finish_reasons": [t["finish_reason"] for t in turns["turns"]],
            "stub_tool_calls": turns["tool_calls"], "stub_tool_ms": turns["tool_ms"],
            "parked_tokens": turns["parked_tokens"],
            "loop_wall_s": {"conveyor": on["wall_s"], "blocking": off["wall_s"]},
            "warmup_s": on["warmup_s"],
        }
    finally:
        tool_pkg.copilot_tools.clear()
        tool_pkg.copilot_tools.update(saved_tools)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(AGENT_DIR, ignore_errors=True)
    report["launches"] = launches
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phases and report device time by kernel group")
    ap.add_argument("--restore-snapshot", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.restore_snapshot:
        return snapshot_child(args.restore_snapshot)

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
    t = time.perf_counter()
    loop = phase_serve_loop(args.seed, smi)
    emit({"phase": "serve_loop", "seconds": time.perf_counter() - t, **loop})
    for name, n in loop["launches"].items():
        launches[name] += n

    t = time.perf_counter()
    agent = phase_agent(args.seed, smi)
    emit({"phase": "agent", "seconds": time.perf_counter() - t, "card": smi,
          "tiny_agent": agent["tiny_agent"], "launches": agent["launches"]})
    emit({"phase": "agent_full_width", **agent["full_width"]})
    for name, n in agent["launches"].items():
        launches[name] += n

    for run in (phase_offload, phase_snapshot):
        t = time.perf_counter()
        out = run(args.seed, smi)
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": run.__name__.removeprefix("phase_"),
              "seconds": time.perf_counter() - t, **out})
        for name, n in out["launches"].items():
            launches[name] += n

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
        latent = get_config_preset(model).mla is not None
        for name in expected_kernels(backend, quantize, kv_quantize, latent):
            launches[name] += (serve["launches"][name]
                               + serve["constrained_launches"].get(name, 0))

    t = time.perf_counter()
    # The dense cuts' bf16 cost (the chat_api phase serves bench-8b).
    bf16_tol = max(r["plain_vs_f32_max_abs_err"] for label, r in e2e_bf16.items()
                   if not label.startswith(DEEPSEEK_V2_LITE.name))
    chat = phase_chat_api(args.seed, smi, bf16_tol)
    emit({"phase": "chat_api", "seconds": time.perf_counter() - t, "card": smi, **chat})
    for name, n in chat["launches"].items():
        launches[name] += n

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
            **{k: r[k] for k in ("event_ms", "dma_ms", "plan") if k in r},
        })
    print(smi)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
