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

The MLA latent instances (``--cases latent``): DeepSeek-V2-Lite's 16 and
V3's 128 heads over one latent kv head of 576 columns, bf16, at the same
ragged S = 128 rows and at ``chip_smoke.py``'s latent decode lengths, base
and new checked and timed the same way, then each latent variant once a
round after them, on the new side:

- ``lat_blocks33`` / ``lat_blocks66``: the plan over 33 / 66 blocks (one
  an SM by default), fewer and longer runs, fewer cut tiles;
- ``lat_run64`` / ``lat_run256``: runs of at least 64 / 256 positions
  (``kLatMinRun``, 128);
- ``lat_ring2``: a ring of 2 stages (3);
- ``lat_cost64`` / ``lat_cost256``: a tile's fixed cost in the plan of 64 /
  256 positions (``kLatCost``, 128); ``lat_empty128``: an empty tile's
  cost 128 (``kLatEmptyCost``, 32);
- ``lat_p_hi``: P in one bf16 half, no lo product (the row reports its
  error against the plain version beside the tolerance, and is timed even
  past it);
- cost ablations, each one step of the stage loop taken out (wrong
  output, timed all the same): ``lat_no_gather`` (no latent copies),
  ``lat_no_scores`` (one of 18 score k-steps), ``lat_no_swap``,
  ``lat_no_softmax``, ``lat_no_products``, and ``lat_skeleton`` (all
  five: the plan, the barriers, q, the stores and the merge).

Each latent row also carries the plan's cut tiles and their partial bytes
beside the latent bytes the call reads.

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
LAT = "attention_latent.cuh"
# Cost ablations: each takes one step out of the latent kernels' stage
# loop (the output is wrong; the time says what the step costs).
GATHER = "          cp_async16(dst + lat_swz(kLatStage, p, c), src + c * 8, row >= 0);"
SCORES = "        wgmma_ss_n32(sc, wgmma_desc(qa, 16, 1024), wgmma_desc(ka, 16, 1024), ks > 0);"
SOFTMAX = (LAT, "      // Masked scores in base-2 units;", "      // P as A fragments (hi + lo)",
           "      float alpha[2] = {1.f, 1.f};\n")
PRODUCTS = (LAT, "      wgmma_fence();\n#pragma unroll\n      for (int kk = 0;",
            "      wgmma_commit();\n      wgmma_wait<0>();\n#pragma unroll\n      for (int k = 0; k < NO;", "")
SWAP = (LAT, "      float* half = swap", "      // Masked scores in base-2 units;", "")
COST_EDITS = {
    "lat_no_gather": [(LAT, GATHER, "          if (c < 0) " + GATHER.lstrip())],
    "lat_no_scores": [(LAT, SCORES, "        if (ks == 0) " + SCORES.lstrip())],
    "lat_no_swap": [SWAP],
    "lat_no_softmax": [SOFTMAX],
    "lat_no_products": [PRODUCTS],
    "lat_skeleton": [(LAT, GATHER, "          if (c < 0) " + GATHER.lstrip()),
                     (LAT, SCORES, "        if (ks == 0) " + SCORES.lstrip()),
                     SWAP, SOFTMAX, PRODUCTS],
}
LAT_EDITS = {  # variant: (header, old, new)
    "lat_run64": (LAT, "kLatMinRun = 128;", "kLatMinRun = 64;"),
    "lat_run256": (LAT, "kLatMinRun = 128;", "kLatMinRun = 256;"),
    "lat_ring2": (LAT, "kLatRing = 3;", "kLatRing = 2;"),
    "lat_cost64": (LAT, "kLatCost = 128;", "kLatCost = 64; "),
    "lat_cost256": (LAT, "kLatCost = 128;", "kLatCost = 256;"),
    "lat_empty128": (LAT, "kLatEmptyCost = 32;", "kLatEmptyCost = 128;"),
    "lat_p_hi": [(LAT, "        wgmma_rs_n256(o, pl[kk], vd);\n", ""),
                 (LAT, "          wgmma_rs_n64(o + 128, pl[kk], vd4);\n", "")],
    **COST_EDITS,
}
LAT_BLOCKS = {"lat_blocks33": 33, "lat_blocks66": 66}
LAT_VARIANTS = (*LAT_BLOCKS, *LAT_EDITS)
LAT_HEADS = {"v2-lite": 16, "v3": 128}
LAT_LENGTHS = [0, 1, 16, 255, 256, 257, 2049, 4096]   # chip_smoke's latent decode rows
STARTS = [3968, 0, 5, 1000, 3001, 0, 200, 17]       # chip_smoke's S = 128 rows
Q_LENS = [128, 128, 0, 1, 77, 1, 128, 33]
LENGTHS = [1, 17, 300, 1024, 2049, 4096, 0, 77]     # chip_smoke's decode rows
WIDTHS = {"dma": (32, 8), "grid": (28, 4)}         # (H, K): bench-8b, Qwen2.5-7B


def copy_sources(name: str, src: str, edit=None) -> str:
    """``src`` copied to build/ab_attention/<name>, cut to head dim 128 and
    bf16 q, with ``edit`` applied: (header, old, new) replaces ``old``;
    (header, start, end, new) replaces the text from ``start`` up to
    ``end``; or a list of them."""
    dst = os.path.join(OUT, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    path = os.path.join(dst, "attention_common.cuh")
    c = open(path).read()
    for d in (16, 32, 64):
        c = c.replace(f"    case {d}: return", f"    case {d}: return cudaErrorInvalidValue; //")
    c = c.replace("  if (dtype == kFloat32) return by_head_dim<float>(D, int8_pages, fn);\n", "")
    open(path, "w").write(c)
    for e in [edit] if isinstance(edit, tuple) else edit or []:
        header, old, new = e[0], e[1], e[-1]
        path = os.path.join(dst, header)
        h = open(path).read()
        if old not in h or (len(e) == 4 and e[2] not in h):
            raise SystemExit(f"{header} changed: cannot find {old!r}")
        if len(e) == 4:   # (header, start, end, new): the text from start to end replaced
            a = h.index(old)
            h = h[:a] + new + h[h.index(e[2], a):]
        else:
            h = h.replace(old, new, 1)
        open(path, "w").write(h)
    return dst


def build(job: tuple[str, str, str]) -> str:
    name, src, source = job
    lib = os.path.join(OUT, f"lib_{name}_{source.split('.')[0]}.so")
    # -fno-gnu-unique: the sides' libraries hold functions of the same names
    # whose static locals (each instance's one-time shared-memory opt-in)
    # must stay each library's own.
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique", "-o", lib,
           os.path.join(src, source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc {name} {source}:\n{res.stderr[-3000:]}")
    return lib


def load(paths: dict[str, str], src: str) -> dict:
    """Both libraries of a side, bound; ``split_dma`` says whether its dma
    decode takes a workspace and splits, ``tile`` and ``walk`` how its grid
    decode is planned."""
    dma = ctypes.CDLL(paths["paged_attention.cu"])
    grid = ctypes.CDLL(paths["paged_attention_grid.cu"]) if "paged_attention_grid.cu" in paths else None
    pa._bind(dma)
    if grid is not None:
        pa._bind_grid(grid)
    split_dma = "const void* lengths, void* workspace" in open(
        os.path.join(src, "paged_attention.cu")).read()
    if not split_dma:
        p, i = ctypes.c_void_p, ctypes.c_int
        dma.opsagent_paged_decode_attention.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, i, p]
    new_plan = os.path.exists(os.path.join(src, "attention_decode.cuh"))
    latent_wg = "int blocks, float scale" in open(os.path.join(src, "paged_attention.cu")).read()
    if not latent_wg:  # the latent entry points before the warpgroup kernels
        p, i = ctypes.c_void_p, ctypes.c_int
        dma.opsagent_paged_ragged_attention_latent.argtypes = [p] * 6 + [i] * 5 + [
            ctypes.c_float, i, p]
        dma.opsagent_paged_decode_attention_latent.argtypes = [p] * 6 + [i] * 6 + [
            ctypes.c_float, i, p]
    return {"dma": dma, "grid": grid, "split_dma": split_dma, "latent_wg": latent_wg,
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


def latent_launcher(side: dict, kind: str, c: dict, copies: list, sms: int,
                    blocks: int | None = None):
    """fn(i) launching ``side``'s latent kernel on case ``c`` with the i-th
    page copy, and its output tensor; the new side over ``blocks`` blocks
    (``pa.latent_blocks`` by default)."""
    q, table = c["q"], c["table"]
    P, max_pages = c["k"].shape[1], table.shape[1]
    H, B = q.shape[-2], q.shape[0]
    out = torch.empty_like(q)
    scale, dt = pa.LATENT_DIM ** -0.5, 1
    lib = side["dma"]
    if side["latent_wg"]:
        blocks = blocks or pa.latent_blocks(sms)
        ws = torch.empty(pa.latent_workspace_bytes(blocks) // 4, device="cuda")
    if kind == "ragged":
        S = q.shape[1]
        ints = (ptr(table), ptr(c["start"]), ptr(c["q_lens"]))
        if side["latent_wg"]:
            return (lambda i: lib.opsagent_paged_ragged_attention_latent(
                ptr(q), ptr(copies[i % len(copies)][0]), *ints, ptr(ws), ptr(out), B, S, H, P,
                max_pages, blocks, scale, dt, stream(q.device))), out
        return (lambda i: lib.opsagent_paged_ragged_attention_latent(
            ptr(q), ptr(copies[i % len(copies)][0]), *ints, ptr(out), B, S, H, P, max_pages,
            scale, dt, stream(q.device))), out
    lengths = c["lengths"]
    if side["latent_wg"]:
        return (lambda i: lib.opsagent_paged_decode_attention_latent(
            ptr(q), ptr(copies[i % len(copies)][0]), ptr(table), ptr(lengths), ptr(ws), ptr(out),
            B, H, P, max_pages, 1, max_pages * P, blocks, scale, dt, stream(q.device))), out
    splits, span, ws = plan(c, 16, pa.DECODE_WALK, sms)
    return (lambda i: lib.opsagent_paged_decode_attention_latent(
        ptr(q), ptr(copies[i % len(copies)][0]), ptr(table), ptr(lengths), ptr(ws), ptr(out),
        B, H, P, max_pages, splits, span, scale, dt, stream(q.device))), out


def latent_rows(sides: dict, variants: list, rounds: int, sms: int, gen) -> list:
    """The latent cases, base and new alternated, then each variant."""
    rows = []
    for heads, H in LAT_HEADS.items():
        for kind in ("ragged", "decode"):
            if kind == "ragged":
                c = cs.make_case(gen, 8, 128, H, 1, pa.LATENT_DIM, 16, STARTS, Q_LENS,
                                 torch.bfloat16)
                want = pa.paged_ragged_attention(c["q"], c["k"], c["k"], c["table"],
                                                 c["start"], c["q_lens"])
            else:
                c = cs.decode_case(gen, 8, H, 1, pa.LATENT_DIM, 16, LAT_LENGTHS, torch.bfloat16)
                want = pa.paged_decode_attention(c["q"], c["k"], c["k"], c["table"],
                                                 c["lengths"])
            c["v"] = c["k"]
            label = f"latent {heads} {kind}"
            copies = cs.page_copies(c)
            fns, errs = {}, {}
            for name in ("base", "new", *variants):
                side = sides[name] if name in sides else sides["new"]
                fn, out = latent_launcher(side, kind, c, copies, sms, LAT_BLOCKS.get(name))
                if name == "lat_p_hi" or name in COST_EDITS:   # timed whatever its error
                    fn(0)
                    torch.cuda.synchronize()
                    errs[name] = (out.float() - want.float()).abs().max().item()
                    fns[name] = fn
                    continue
                fns[name] = checked(fn, out, want, f"{name} {label}")
                errs[name] = (out.float() - want.float()).abs().max().item()
            times = {name: [] for name in fns}
            for _ in range(rounds):
                for name in ("base", "new", "new", "base", *variants):
                    times[name].append(cs.graph_ms(fns[name]))
            row = {"case": label, "ms": times,
                   "median_ms": {n: statistics.median(v) for n, v in times.items()},
                   "max_abs_err": errs, "tol": cs.TOL[torch.bfloat16],
                   "plan": {n: cs.latent_plan_bytes(c, LAT_BLOCKS.get(n) or pa.latent_blocks(sms))
                            for n in ("new", *[v for v in variants if v in LAT_BLOCKS])}}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del copies, fns, want, c
            torch.cuda.empty_cache()
    return rows


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
    ap.add_argument("--latent-variants", nargs="*", default=list(LAT_VARIANTS),
                    choices=LAT_VARIANTS)
    ap.add_argument("--cases", choices=("gqa", "latent", "all"), default="all")
    args = ap.parse_args()
    if args.cases == "latent":
        args.variants = []
    if args.cases == "gqa":
        args.latent_variants = []
    if not torch.cuda.is_available():
        print("ab_attention: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    srcs = {"base": copy_sources("base", os.path.abspath(args.base)),
            "new": copy_sources("new", str(CSRC))}
    for name in args.variants:
        if name in EDITS:
            srcs[name] = copy_sources(name, str(CSRC), EDITS[name])
    for name in args.latent_variants:
        if name in LAT_EDITS:
            srcs[name] = copy_sources(name, str(CSRC), LAT_EDITS[name])
    jobs = [(name, src, source) for name, src in srcs.items() for source in SOURCES
            if name not in LAT_EDITS or source == "paged_attention.cu"]   # latent: dma only
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(build, jobs))
    sides = {name: load({source: lib for (n, _, source), lib in zip(jobs, built) if n == name},
                        src) for name, src in srcs.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    if args.cases != "gqa":
        rows += latent_rows(sides, args.latent_variants, args.rounds, sms, gen)
    for form, (H, K) in WIDTHS.items() if args.cases != "latent" else ():
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
                    if name in LAT_EDITS or (name in EDITS and kind == "ragged"):
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
