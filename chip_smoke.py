#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``opsagent_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, each printing one JSON line with its seconds:

1. device: requires CUDA; reads the card's name and power limit.
2. build: compiles the paged-attention kernels from ``opsagent_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16 and f32, at the widths of bench-8b (Llama-3-8B), bench-1b and
   tiny-test; errors, times, and the bound for the main path's shapes.
4. e2e: bench-8b widths cut to 2 layers, f32: ``Engine.generate`` through the
   kernels gives exactly the greedy tokens of the same engine through the
   plain versions, with a prefix-cache hit.
5. serve: bench-8b at full depth, bf16, random weights from ``--seed``,
   behind the HTTP server; four concurrent chat completions. The kernels'
   launch counts of this run are checked and reported. With ``--profile``
   the run is traced with ``torch.profiler`` and a ``profile`` line gives
   device time by kernel group (the trace slows the run: its tokens/s and
   TTFT are not the untraced ones).

Then, on lines of their own: the card's name and power limit as nvidia-smi
prints them, the ``{"kernels": [...]}`` table, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
those lines.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import replace

import torch
import torch.nn.functional as F

from opsagent_tpu_torch.models.config import BENCH_8B, get_config_preset
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.ops import paged_attention as pa
from opsagent_tpu_torch.ops.attention import _gather_kv
from opsagent_tpu_torch.serving.api import ServingStack, make_server
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
SOURCE = "opsagent_tpu_torch/csrc/paged_attention.cu"
REPLACES = {
    "paged_ragged_attention": "opsagent_tpu/ops/paged_attention_pallas.py:830",
    "paged_decode_attention": "opsagent_tpu/ops/paged_attention_pallas.py:310",
}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


# -- phase 3: kernels against their plain versions ---------------------------
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


def attention_bound_ms(c, int_arrays: int) -> tuple[float, str]:
    """Least time for this input (ragged ``[B, S, H, D]`` or decode
    ``[B, H, D]`` q). Bytes, each once: the K/V rows each sequence can see,
    the table entries of the pages that hold them, the valid query rows
    (a padding row's output is zeros whatever q holds there), the
    ``int_arrays`` int32 ``[B]`` inputs the kernel reads, and the whole
    output written. Operations: 4 * D per (query head, valid query row,
    position it sees)."""
    q, k = c["q"], c["k"]
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    P, K = k.shape[1], k.shape[2]
    cap = c["table"].shape[1] * P
    rows = list(zip(c["start"].tolist(), c["q_lens"].tolist()))
    visible = [min(s + n, cap) if n > 0 else 0 for s, n in rows]
    elt = q.element_size()
    nbytes = (
        sum(n for _, n in rows) * H * D * elt
        + q.numel() * elt
        + 2 * sum(visible) * K * D * k.element_size()
        + sum(math.ceil(v / P) for v in visible) * 4
        + int_arrays * B * 4
    )
    ops = 4 * H * D * sum(min(s + i + 1, cap) for s, n in rows for i in range(n))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ragged_sdpa(c):
    """The PyTorch yardstick: scaled_dot_product_attention over K/V that
    are already gathered and expanded to the query heads, with the ragged
    causal mask (fully masked rows come out NaN: timing only)."""
    q = c["q"]
    B, S, H, D = q.shape
    k_seq, v_seq = _gather_kv(c["k"], c["v"], c["table"], None)
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


def run_kernel_case(name, c, dtype, timed):
    if name == "paged_ragged_attention":
        args = (c["q"], c["k"], c["v"], c["table"], c["start"], c["q_lens"])
        fn = pa.paged_ragged_attention_cuda
    else:
        args = (c["q"], c["k"], c["v"], c["table"], c["lengths"])
        fn = pa.paged_decode_attention_cuda
    got = fn(*args)
    want = fn(*args, plain=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= TOL[dtype],
          f"{name} {tuple(c['q'].shape)} {dtype}: max err {err} > {TOL[dtype]}")
    out = {"max_abs_err": err}
    if timed:
        out["ms"] = time_ms(lambda: fn(*args))
        out["plain_ms"] = time_ms(lambda: fn(*args, plain=True), iters=3)
        out["library_ms"] = time_ms(c["sdpa"])
        out["bound_ms"], out["bound_by"] = c["bound"]
    return out


def decode_case(gen, B, H, K, D, P, lengths, dtype):
    """Decode inputs as a ragged case with one query per row: lengths
    include the new token, so start = length - 1 and q_len = 1 (0 for an
    empty row)."""
    c = make_case(
        gen, B, 1, H, K, D, P, [max(n - 1, 0) for n in lengths],
        [1 if n else 0 for n in lengths], dtype,
    )
    c["lengths"] = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    c["q"] = c["q"][:, 0]
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
        ("bench-1b", 32, 8, 64, 16),
        ("tiny-test", 4, 2, 16, 4),
    ]
    results: dict[str, dict] = {}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for wname, H, K, D, P in widths:
            main = wname == "bench-8b" and dtype == torch.bfloat16
            for S, (starts, lens) in ragged_rows.items():
                if wname != "bench-8b" and S != 16:
                    continue
                c = make_case(gen, 8, S, H, K, D, P, starts, lens, dtype)
                timed = main and S == 128   # the main path's prefill chunk shape
                if timed:
                    c["bound"] = attention_bound_ms(c, int_arrays=2)  # start, q_lens
                    c["sdpa"] = ragged_sdpa(c)
                r = run_kernel_case("paged_ragged_attention", c, dtype, timed)
                cases.append(dict(kernel="ragged", width=wname, S=S,
                                  dtype=str(dtype)[6:], err=r["max_abs_err"],
                                  tol=TOL[dtype]))
                if timed:
                    results["paged_ragged_attention"] = r
                del c
            c = decode_case(gen, 8, H, K, D, P, decode_lengths, dtype)
            if main:
                c["bound"] = attention_bound_ms(c, int_arrays=1)  # lengths
                c["sdpa"] = ragged_sdpa({**c, "q": c["q"][:, None]})
            r = run_kernel_case("paged_decode_attention", c, dtype, main)
            cases.append(dict(kernel="decode", width=wname, dtype=str(dtype)[6:],
                              err=r["max_abs_err"], tol=TOL[dtype]))
            if main:
                results["paged_decode_attention"] = r
            del c
    emit({"phase": "kernels_cases", "cases": cases})
    return results


# -- phase 4: end-to-end equality through kernels and plain versions -----------
def phase_e2e(seed: int) -> dict:
    cfg = replace(BENCH_8B, name="bench-8b-2l", num_layers=2)
    model = Llama(cfg, torch.float32, "cuda", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    p0 = [257] + torch.randint(0, 256, (299,), generator=gen).tolist()
    p1 = [257] + torch.randint(0, 256, (199,), generator=gen).tolist()
    p2 = p0[:100] + torch.randint(0, 256, (60,), generator=gen).tolist()
    greedy = SamplingParams(max_tokens=16)
    out = {}
    for impl in ("cuda", "plain"):
        eng = Engine(
            EngineConfig(model=cfg.name, dtype=torch.float32, device="cuda",
                         attn_impl=impl, seed=seed, num_pages=256),
            model_cfg=cfg, model=model,
        )
        # p2 is admitted after p0 finished and donated its pages: a hit.
        toks = eng.generate([p0, p1], greedy) + eng.generate([p2], greedy)
        out[impl] = (toks, eng.alloc.hit_tokens)
        del eng
    (tk, hk), (tp, hp) = out["cuda"], out["plain"]
    check(all(len(t) == 16 for t in tk), f"kernel path lengths {[len(t) for t in tk]}")
    check(tk == tp, f"kernel-path tokens {tk} != plain-path tokens {tp}")
    check(hk > 0 and hp == hk, f"prefix hits {hk} / {hp}")
    return {"tokens_equal": True, "prefix_hit_tokens": hk, "tokens": tk}


# -- phase 5: serving at full width -------------------------------------------
KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names)
    ("paged_ragged_attention", ("ragged_kernel",)),
    ("paged_decode_attention", ("decode_kernel",)),
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")),
)


def device_time_by_group(prof) -> dict:
    """Self device time (ms) of every kernel in the trace, by group."""
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us <= 0:
            continue
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        out[group] = out.get(group, 0.0) + us / 1e3
    return out


def phase_serve(seed: int, smi: str, profile: bool = False) -> dict:
    engine = Engine(EngineConfig(model="bench-8b", dtype=torch.bfloat16,
                                 device="cuda", seed=seed))
    cfg = get_config_preset("bench-8b")
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
        {"model": "bench-8b", "temperature": 0, "max_tokens": 64,
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

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pa.reset_launch_counts()
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
        launches = dict(pa.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        stack.close()
        thread.join(timeout=30)
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
    for name, n in launches.items():
        check(n > 0 and n % cfg.num_layers == 0,
              f"{name} launched {n} times, not a positive multiple of {cfg.num_layers}")
    completion = sum(r["usage"]["completion_tokens"] for _, r in replies)
    if profile:
        groups = device_time_by_group(prof)
        emit({"phase": "profile", "card": smi, "wall_ms": wall * 1e3,
              "device_ms": groups, "device_busy_share":
              sum(groups.values()) / (wall * 1e3)})
    return {
        "card": smi,
        "prompt_tokens": [r["usage"]["prompt_tokens"] for _, r in replies],
        "completion_tokens": completion,
        "wall_s": wall,
        "completion_tok_per_s": completion / wall,
        "ttft_p50_s": statistics.median(r["ttft_s"] for _, r in replies),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phase and report device time by kernel group")
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
    lib, log = pa.build(verbose=True)
    print(log, file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t, "library": lib.name})

    t = time.perf_counter()
    kernels = phase_kernels(args.seed)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t, "card": smi,
          **kernels})

    t = time.perf_counter()
    e2e = phase_e2e(args.seed)
    torch.cuda.empty_cache()
    emit({"phase": "e2e", "seconds": time.perf_counter() - t, **e2e})

    t = time.perf_counter()
    serve = phase_serve(args.seed, smi, args.profile)
    emit({"phase": "serve", "seconds": time.perf_counter() - t, **serve})

    rows = []
    for name, r in kernels.items():
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": serve["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(smi)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
