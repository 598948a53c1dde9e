#!/usr/bin/env python3
"""Where the time of the tensor-core ragged attention body goes, on the GPU.

    python3 scripts/ablate_attention_mma.py [variant ...]

Copies ``opsagent_tpu_torch/csrc`` to ``build/ablate/src``, inserts compile
switches into the copy of ``attention_mma.cuh`` that each take one part of
the body away, builds every variant of both attention sources (head dim
128, bf16 q only, to keep the builds short) in parallel, and times the
bf16 ragged kernels of both forms, pages in bf16 and int8, at
``chip_smoke.py``'s timed S = 128 shapes (dma form at bench-8b width, grid
form at Qwen2.5-7B width) through their C entry points. A variant without
a part computes wrong numbers: only ``base`` is checked against the plain
version. Prints one line per (variant, form, page type) and the card's
name; writes ``build/ablate/ablate_attention_mma.json``.

Variants (all by default): base; no_lo (P.V without the lo half of P);
no_qk_pv (neither product); no_exp (no exp2); no_gather (no page copies,
pages in q's dtype); chunk32 (32-position chunks).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opsagent_tpu_torch.ops import paged_attention as pa  # noqa: E402
from opsagent_tpu_torch.ops.cuda_build import CSRC, _nvcc, ptr, stream  # noqa: E402

OUT = os.path.join(ROOT, "build", "ablate")
VARIANTS = {
    "base": [], "no_lo": ["-DABLATE_NO_LO"],
    "no_qk_pv": ["-DABLATE_NO_QK", "-DABLATE_NO_PV", "-DABLATE_NO_LO"],
    "no_exp": ["-DABLATE_NO_EXP"], "no_gather": ["-DABLATE_NO_GATHER"],
    "chunk32": ["-DABLATE_CHUNK=32"],
}
SOURCES = ("paged_attention.cu", "paged_attention_grid.cu")
STARTS = [3968, 0, 5, 1000, 3001, 0, 200, 17]
Q_LENS = [128, 128, 0, 1, 77, 1, 128, 33]


def guard(text: str, old: str, macro: str) -> str:
    """``old`` (which must be in ``text``) compiled only without ``macro``."""
    if old not in text:
        raise SystemExit(f"attention_mma.cuh changed: cannot find {old!r}")
    return text.replace(old, f"#ifndef {macro}\n{old}\n#endif\n", 1)


def patched_sources() -> str:
    src = os.path.join(OUT, "src")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    path = os.path.join(src, "attention_mma.cuh")
    h = open(path).read()
    h = guard(h, "          mma_bf16(sc[2 * np], qa[kq], b[0], b[1]);\n"
                 "          mma_bf16(sc[2 * np + 1], qa[kq], b[2], b[3]);", "ABLATE_NO_QK")
    h = guard(h, "          mma_bf16(o[2 * dp], pl, b[0], b[1]);\n"
                 "          mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);", "ABLATE_NO_LO")
    h = guard(h, "          mma_bf16(o[2 * dp], ph, b[0], b[1]);\n"
                 "          mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);", "ABLATE_NO_PV")
    h = guard(h, "      cp_async16(ks + j * LD + c, k_pages + at, row >= 0);\n"
                 "      cp_async16(vs + j * LD + c, v_pages + at, row >= 0);", "ABLATE_NO_GATHER")
    old = "const float p = exp2f(sc[nt][e] - base[e >> 1]);"
    if old not in h:
        raise SystemExit(f"attention_mma.cuh changed: cannot find {old!r}")
    h = h.replace(old, "\n#ifdef ABLATE_NO_EXP\nconst float p = sc[nt][e] - base[e >> 1];\n"
                       f"#else\n{old}\n#endif\n")
    old = "constexpr int kMmaChunk = 64;"
    if old not in h:
        raise SystemExit(f"attention_mma.cuh changed: cannot find {old!r}")
    h = h.replace(old, f"#ifdef ABLATE_CHUNK\nconstexpr int kMmaChunk = ABLATE_CHUNK;\n#else\n{old}\n#endif")
    open(path, "w").write(h)
    # Only the instances timed here: bf16 q, head dim 128.
    path = os.path.join(src, "attention_common.cuh")
    c = open(path).read()
    for d in (16, 32, 64):
        c = c.replace(f"    case {d}: return", f"    case {d}: return cudaErrorInvalidValue; //")
    c = c.replace("  if (dtype == kFloat32) return by_head_dim<float>(D, int8_pages, fn);\n", "")
    open(path, "w").write(c)
    return src


def build(job) -> str:
    src, name, flags, source = job
    lib = os.path.join(OUT, f"lib_{name}_{source.split('.')[0]}.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", *flags, "-o", lib, os.path.join(src, source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc {name} {source}:\n{res.stderr[-3000:]}")
    return lib


def launcher(lib: ctypes.CDLL, form: str, c: dict):
    """fn(i) launching the kernel of ``lib`` on case ``c``, and its output."""
    q, table, start, q_lens = c["q"], c["table"], c["start"], c["q_lens"]
    (kv, ks), (vv, vs) = pa._planes(c["k"]), pa._planes(c["v"])
    B, S, H, D = q.shape
    P, K = kv.shape[1], kv.shape[2]
    out = torch.empty_like(q)
    head = (ptr(q), ptr(kv), ptr(vv), ptr(ks), ptr(vs), ptr(table), ptr(start), ptr(q_lens))
    if form == "dma":
        pa._bind(lib)
        return (lambda i: lib.opsagent_paged_ragged_attention(
            *head, ptr(out), B, S, H, K, D, P, table.shape[1], D ** -0.5, 1,
            stream(q.device))), out
    pa._bind_grid(lib)
    splits, span, ws = pa._grid_plan(q, "ragged", S, K, P, table.shape[1])
    return (lambda i: lib.opsagent_paged_ragged_attention_grid(
        *head, ptr(ws), ptr(out), B, S, H, K, D, P, table.shape[1], splits, span,
        D ** -0.5, 1, stream(q.device))), out


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_attention_mma: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    src = patched_sources()
    jobs = [(src, n, VARIANTS[n], s) for n in names for s in SOURCES]
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        libs = list(ex.map(build, jobs))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for form, (H, K) in (("dma", (32, 8)), ("grid", (28, 4))):
        c = cs.make_case(gen, 8, 128, H, K, 128, 16, STARTS, Q_LENS, torch.bfloat16)
        cases[form, "bf16"], cases[form, "int8"] = c, cs.quantize_case(c)
    rows = []
    for (_, name, _, source), path in zip(jobs, libs):
        lib = ctypes.CDLL(path)
        form = "dma" if source == "paged_attention.cu" else "grid"
        for pages in ("bf16", "int8"):
            c = cases[form, pages]
            fn, out = launcher(lib, form, c)
            cuda_rc = fn(0)
            if cuda_rc:
                raise SystemExit(f"{name} {form} {pages}: CUDA error {cuda_rc}")
            row = {"variant": name, "form": form, "pages": pages, "ms": cs.time_ms(fn, iters=30)}
            if name == "base":
                want = pa.paged_ragged_attention(c["q"], c["k"], c["v"], c["table"],
                                                 c["start"], c["q_lens"])
                row["max_abs_err"] = (out.float() - want.float()).abs().max().item()
            rows.append(row)
            print(json.dumps(row), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    with open(os.path.join(OUT, "ablate_attention_mma.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
