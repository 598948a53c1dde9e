#!/usr/bin/env python3
"""The paged-attention kernels against an earlier version of their sources,
and variants of the decode routine, in one call on the GPU.

    python3 scripts/ab_attention.py BASE_CSRC [--rounds N] [--variants NAME ...]

``BASE_CSRC`` is an earlier ``opsagent_tpu_torch/csrc`` directory, for
example the parent commit unpacked with ``git archive`` under ``build/``.
Both sides' attention sources are built with nvcc from copies under
``build/ab_attention/`` (head dim 128 and bf16 q only, to keep the builds
short) and bound through ctypes; a dma decode entry point from before the
``workspace``, ``splits`` and ``span`` arguments is bound with its own
signature, and a grid decode from before ``DECODE_WALK`` is planned as it
was (8-row tiles, no walk bound). Every case of ``chip_smoke.py``'s timed
attention rows (ragged S = 128 and decode; the dma form at bench-8b width,
the grid form at Qwen2.5-7B width; bf16 and int8 pages) is checked against
the plain version on every side, then timed by CUDA graph replay over
copies of its pages that pass 100 MB (``chip_smoke.graph_ms``,
``page_copies``), in the order base, new, new, base, ``N`` rounds (default
2), each decode variant once a round after them:

- ``ring3`` / ``ring4``: a 3- or 4-slice ring in each warp (2 in the
  source);
- ``walk128`` / ``walk512``: splits of at most 128 / 512 positions (256);
- ``mma_s1``: the decode through the grid form's ragged kernel at S = 1
  (``attend_mma``, one query row a sequence) over the same splits.

Prints one line per case with every time of every side and their medians,
then the card's name; writes ``build/ab_attention/ab_attention.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opsagent_tpu_torch.ops import paged_attention as pa  # noqa: E402
from opsagent_tpu_torch.ops.cuda_build import CSRC, _nvcc, ptr, stream  # noqa: E402

OUT = os.path.join(ROOT, "build", "ab_attention")
SOURCES = ("paged_attention.cu", "paged_attention_grid.cu")
RING = "constexpr int kDecodeRing = 2;"
EDITS = {  # variant: (header, old, new)
    "ring3": ("attention_decode.cuh", RING, RING.replace("2", "3")),
    "ring4": ("attention_decode.cuh", RING, RING.replace("2", "4")),
}
WALKS = {"walk128": 128, "walk512": 512}
VARIANTS = (*EDITS, *WALKS, "mma_s1")
STARTS = [3968, 0, 5, 1000, 3001, 0, 200, 17]       # chip_smoke's S = 128 rows
Q_LENS = [128, 128, 0, 1, 77, 1, 128, 33]
LENGTHS = [1, 17, 300, 1024, 2049, 4096, 0, 77]     # chip_smoke's decode rows
WIDTHS = {"dma": (32, 8), "grid": (28, 4)}         # (H, K): bench-8b, Qwen2.5-7B


def copy_sources(name: str, src: str, edit: tuple[str, str, str] | None = None) -> str:
    """``src`` copied to build/ab_attention/<name>, cut to head dim 128 and
    bf16 q, with ``edit`` (header, old, new) applied."""
    dst = os.path.join(OUT, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    path = os.path.join(dst, "attention_common.cuh")
    c = open(path).read()
    for d in (16, 32, 64):
        c = c.replace(f"    case {d}: return", f"    case {d}: return cudaErrorInvalidValue; //")
    c = c.replace("  if (dtype == kFloat32) return by_head_dim<float>(D, int8_pages, fn);\n", "")
    open(path, "w").write(c)
    if edit is not None:
        header, old, new = edit
        path = os.path.join(dst, header)
        h = open(path).read()
        if old not in h:
            raise SystemExit(f"{header} changed: cannot find {old!r}")
        open(path, "w").write(h.replace(old, new, 1))
    return dst


def build(job: tuple[str, str, str]) -> str:
    name, src, source = job
    lib = os.path.join(OUT, f"lib_{name}_{source.split('.')[0]}.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", lib, os.path.join(src, source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc {name} {source}:\n{res.stderr[-3000:]}")
    return lib


def load(paths: dict[str, str], src: str) -> dict:
    """Both libraries of a side, bound; ``split_dma`` says whether its dma
    decode takes a workspace and splits, ``tile`` and ``walk`` how its grid
    decode is planned."""
    dma, grid = ctypes.CDLL(paths["paged_attention.cu"]), ctypes.CDLL(paths["paged_attention_grid.cu"])
    pa._bind(dma)
    pa._bind_grid(grid)
    split_dma = "const void* lengths, void* workspace" in open(
        os.path.join(src, "paged_attention.cu")).read()
    if not split_dma:
        p, i = ctypes.c_void_p, ctypes.c_int
        dma.opsagent_paged_decode_attention.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, i, p]
    new_plan = os.path.exists(os.path.join(src, "attention_decode.cuh"))
    return {"dma": dma, "grid": grid, "split_dma": split_dma,
            "tile": 16 if new_plan else 8, "walk": pa.DECODE_WALK if new_plan else None}


def plan(c, tile: int, walk: int | None, sms: int) -> tuple[int, int, torch.Tensor]:
    """(splits, span, workspace) of a decode call planned with ``tile`` heads
    a tile and walk bound ``walk``."""
    q = c["q"]
    B, H, D = q.shape
    K, P, max_pages = c["k"].shape[2], c["k"].shape[1], c["table"].shape[1]
    splits, span = pa.grid_splits(B * K * -(-(H // K) // tile), B * H, D, max_pages, P, sms,
                                  walk)
    return splits, span, torch.empty(splits * B * H * (D + 2), device="cuda")


def launcher(side: dict, form: str, kind: str, c: dict, copies: list, sms: int,
             walk: int | None = None, mma_s1: bool = False):
    """fn(i) launching ``side``'s kernel on case ``c`` with the i-th page
    copy, and its output tensor."""
    q, table = c["q"], c["table"]
    kv = pa._planes(c["k"])[0]
    P, K, max_pages = kv.shape[1], kv.shape[2], table.shape[1]
    D, H, B = q.shape[-1], q.shape[-2], q.shape[0]
    out = torch.empty_like(q)
    scale, dt = D ** -0.5, 1

    def st():  # the current stream at each launch: graph capture swaps it
        return stream(q.device)

    def pages(i):
        (k, s1), (v, s2) = (pa._planes(t) for t in copies[i % len(copies)])
        return ptr(k), ptr(v), ptr(s1), ptr(s2)

    if kind == "ragged":
        S = q.shape[1]
        ints = (ptr(table), ptr(c["start"]), ptr(c["q_lens"]))
        if form == "dma":
            return (lambda i: side["dma"].opsagent_paged_ragged_attention(
                ptr(q), *pages(i), *ints, ptr(out), B, S, H, K, D, P, max_pages, scale, dt,
                st())), out
        splits, span, ws = pa._grid_plan(q, "ragged", S, K, P, max_pages)
        return (lambda i: side["grid"].opsagent_paged_ragged_attention_grid(
            ptr(q), *pages(i), *ints, ptr(ws), ptr(out), B, S, H, K, D, P, max_pages, splits,
            span, scale, dt, st())), out
    lengths = c["lengths"]
    splits, span, ws = plan(c, side["tile"], walk or side["walk"], sms)
    if mma_s1:
        q1, out1 = q[:, None], out[:, None]
        start = (lengths - 1).clamp(min=0).int()
        q_lens = (lengths > 0).int()
        return (lambda i: side["grid"].opsagent_paged_ragged_attention_grid(
            ptr(q1), *pages(i), ptr(table), ptr(start), ptr(q_lens), ptr(ws), ptr(out1), B, 1,
            H, K, D, P, max_pages, splits, span, scale, dt, st())), out
    if form == "grid":
        return (lambda i: side["grid"].opsagent_paged_decode_attention_grid(
            ptr(q), *pages(i), ptr(table), ptr(lengths), ptr(ws), ptr(out), B, H, K, D, P,
            max_pages, splits, span, scale, dt, st())), out
    if side["split_dma"]:
        return (lambda i: side["dma"].opsagent_paged_decode_attention(
            ptr(q), *pages(i), ptr(table), ptr(lengths), ptr(ws), ptr(out), B, H, K, D, P,
            max_pages, splits, span, scale, dt, st())), out
    return (lambda i: side["dma"].opsagent_paged_decode_attention(
        ptr(q), *pages(i), ptr(table), ptr(lengths), ptr(out), B, H, K, D, P, max_pages,
        scale, dt, st())), out


def checked(fn, out, want, label: str):
    """``fn``, raising on a failed launch, after one launch whose output
    agrees with ``want``."""
    def launch(i):
        rc = fn(i)
        if rc:
            raise SystemExit(f"{label}: CUDA error {rc}")

    launch(0)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    if not err <= cs.TOL[torch.bfloat16]:
        raise SystemExit(f"{label}: max err {err}")
    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="an earlier opsagent_tpu_torch/csrc directory")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS), choices=VARIANTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_attention: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    srcs = {"base": copy_sources("base", os.path.abspath(args.base)),
            "new": copy_sources("new", str(CSRC))}
    for name in args.variants:
        if name in EDITS:
            srcs[name] = copy_sources(name, str(CSRC), EDITS[name])
    jobs = [(name, src, source) for name, src in srcs.items() for source in SOURCES]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(build, jobs))
    sides = {name: load({source: lib for (n, _, source), lib in zip(jobs, built) if n == name},
                        src) for name, src in srcs.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for form, (H, K) in WIDTHS.items():
        for kind in ("ragged", "decode"):
            if kind == "ragged":
                c = cs.make_case(gen, 8, 128, H, K, 128, 16, STARTS, Q_LENS, torch.bfloat16)
            else:
                c = cs.decode_case(gen, 8, H, K, 128, 16, LENGTHS, torch.bfloat16)
            for pages, case in (("bf16", c), ("int8", cs.quantize_case(c))):
                label = f"{form} {kind} {pages}"
                if kind == "ragged":
                    want = pa.paged_ragged_attention(case["q"], case["k"], case["v"],
                                                     case["table"], case["start"], case["q_lens"])
                else:
                    want = pa.paged_decode_attention(case["q"], case["k"], case["v"],
                                                     case["table"], case["lengths"])
                copies = cs.page_copies(case)
                fns = {}
                for name, side in sides.items():
                    if name in EDITS and kind == "ragged":
                        continue
                    fns[name] = checked(*launcher(side, form, kind, case, copies, sms), want,
                                        f"{name} {label}")
                if kind == "decode":
                    for name in args.variants:
                        if name in WALKS:
                            fns[name] = checked(*launcher(sides["new"], form, kind, case, copies,
                                                          sms, walk=WALKS[name]), want,
                                                f"{name} {label}")
                        elif name == "mma_s1":
                            fns[name] = checked(*launcher(sides["new"], form, kind, case, copies,
                                                          sms, mma_s1=True), want,
                                                f"{name} {label}")
                times = {name: [] for name in fns}
                for _ in range(args.rounds):
                    for name in ("base", "new", "new", "base", *[n for n in fns if n not in
                                                                 ("base", "new")]):
                        times[name].append(cs.graph_ms(fns[name]))
                row = {"case": label, "ms": times,
                       "median_ms": {n: statistics.median(v) for n, v in times.items()}}
                rows.append(row)
                print(json.dumps(row), flush=True)
                del copies, fns, want
                torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    with open(os.path.join(OUT, "ab_attention.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
