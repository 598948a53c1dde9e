#!/usr/bin/env python3
"""The bf16 materialized-MLA ragged kernel (``csrc/attention_mla.cuh``)
against an earlier version of the sources and against variants of itself,
in one call on the GPU.

    python3 scripts/ab_mla.py BASE_CSRC [--rounds N] [--variants NAME ...]

``BASE_CSRC`` is an earlier ``opsagent_tpu_torch/csrc`` directory, for
example the parent commit unpacked with ``git archive`` under ``build/``;
its bf16 ragged call at head dim 192 is taken through
``opsagent_paged_ragged_attention`` (before this kernel: ``attend_mma``)
unless it has ``opsagent_paged_ragged_attention_mla``. Every side's
``paged_attention.cu`` is built with nvcc (``-Xptxas -v``) from a copy
under ``build/ab_mla/``, the variants by string edits of the new sources;
each row reports ptxas's registers and spills of the kernel and the
local-memory loads and stores (``LDL`` / ``STL``) that ``cuobjdump -sass``
finds in it. The case is ``chip_smoke.py``'s timed materialized row
(DeepSeek-V2-Lite, 16 heads of 192, a kv head each, v zero past 128; the
ragged rows at S = 128), checked against the plain version on every side,
then timed by CUDA graph replay over copies of its pages that pass 100 MB
(``chip_smoke.graph_ms``, ``page_copies``), in the order base, new, new,
base, ``N`` rounds (default 2), each variant once a round after them;
SDPA over the gathered K/V and the bound once. Variants:

- ``blocks1`` / ``blocks_sm``: the plan over 1 block / one block an SM (two
  by default); no rebuild;
- ``unroll2`` / ``unroll12``: the producer's copy loop unrolled 2 / 12
  times (not unrolled in the source);
- ``regs88``: setmaxnreg 88 in the producer, 168 in the consumer (56 and
  200);
- ``ring2``: a ring of 2 stages (3);
- cost ablations, one step of the stage loop taken out (wrong output,
  timed all the same): ``no_gather`` (no K/V copies), ``no_scores``
  (one of 12 score k-steps), ``no_softmax`` (no mask, exponentials or
  rescale), ``no_products`` (no P V), ``no_lo`` (P in one bf16 half),
  ``no_merge`` (no merge launch), ``merge_noop`` (the merge launched and
  returning at once), ``no_zeros`` (no zeros written for tiles that see
  nothing), and ``skeleton`` (the first four at
  once: the plan, the barriers, q, the stores and the merge).

Prints one JSON line per side with its times and their median, then the
card's name; writes ``build/ab_mla/ab_mla.json``.
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

OUT = os.path.join(ROOT, "build", "ab_mla")
H, D, V_DIM, P = 16, 192, 128, 16
H_ = "attention_mla.cuh"
VARIANTS = {  # name: string edits (header, old, new) of the new sources
    "unroll2": [(H_, "#pragma unroll 1\n      for (int n = 0; n < PW * CP / kWarp; ++n) {",
                 "#pragma unroll 2\n      for (int n = 0; n < PW * CP / kWarp; ++n) {")],
    "unroll12": [(H_, "#pragma unroll 1\n      for (int n = 0; n < PW * CP / kWarp; ++n) {",
                  "#pragma unroll\n      for (int n = 0; n < PW * CP / kWarp; ++n) {")],
    "regs88": [(H_, "kMlaProducerRegs = 56;", "kMlaProducerRegs = 88;"),
               (H_, "kMlaConsumerRegs = 200;", "kMlaConsumerRegs = 168;")],
    "ring2": [(H_, "kMlaRing = 3;", "kMlaRing = 2;")],
    "no_gather": [(H_, "cp_async16(dst + (is_v", "if (false) cp_async16(dst + (is_v")],
    "no_scores": [(H_, "for (int ks = 0; ks < KS; ++ks) {", "for (int ks = 0; ks < 1; ++ks) {")],
    "no_products": [(H_, "wgmma_rs_n192(o, ph[kk], vd);\n        wgmma_rs_n192(o, pl[kk], vd);",
                     "")],
    "no_lo": [(H_, "        wgmma_rs_n192(o, pl[kk], vd);", "")],
    "no_softmax": [(H_, "      // Masked scores in base-2 units",
                    "      // P as A fragments (hi + lo)", "      l[0] = l[1] = 1.f;\n")],
    "no_merge": [(H_, "  mla_ragged_merge_kernel<<<", "  if (false) mla_ragged_merge_kernel<<<")],
    "merge_noop": [("attention_plan.cuh", "  if (task.x < 0) return;", "  return;")],
    "no_zeros": [(H_, "        st_if(out + job.out_row(u.item, min(r, rows - 1))",
                  "        if (false) st_if(out + job.out_row(u.item, min(r, rows - 1))")],
}
# Every step of the stage loop taken out: the plan, the barriers, q, the
# stores and the merge are left.
VARIANTS["skeleton"] = [e for v in ("no_gather", "no_scores", "no_softmax", "no_products")
                        for e in VARIANTS[v]]
RUNTIME = {"blocks1": lambda sms: 1, "blocks_sm": lambda sms: sms}


def copy_sources(name: str, src: str, edits=()) -> str:
    dst = os.path.join(OUT, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for e in edits:   # (header, old, new), or (header, start, end, new): start..end replaced
        header, old, new = e[0], e[1], e[-1]
        path = os.path.join(dst, header)
        text = open(path).read()
        if old not in text or (len(e) == 4 and e[2] not in text):
            raise SystemExit(f"{header} changed: cannot find {old!r}")
        if len(e) == 4:
            a = text.index(old)
            text = text[:a] + new + text[text.index(e[2], a):]
        else:
            text = text.replace(old, new, 1)
        open(path, "w").write(text)
    return dst


def build(job: tuple[str, str]) -> tuple[str, dict]:
    """The side's library and ptxas's and the SASS's account of its kernel."""
    name, src = job
    lib = os.path.join(OUT, f"lib_{name}.so")
    # -fno-gnu-unique: each library keeps its own static locals (the
    # one-time shared-memory opt-in of each kernel).
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique",
           "-o", lib, os.path.join(src, "paged_attention.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc {name}:\n{res.stderr[-3000:]}")
    want = "mla_ragged_wg_kernel" if "attention_mla.cuh" in os.listdir(src) else \
        "ragged_kernel<__nv_bfloat16, __nv_bfloat16, 192"
    rows = [r for r in cs.ptxas_report(res.stdout + res.stderr) if want in r["kernel"]]
    info = rows[0] if rows else {}
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "mla_ragged_wg" in line or ("ragged_kernel" in line and "Li192E" in line
                                                   and "bfloat16" in line)
        elif inside:
            body.append(line)
    info.update(sass_stl=sum(" STL" in x for x in body), sass_ldl=sum(" LDL" in x for x in body))
    return lib, info


def side_fn(lib: ctypes.CDLL, c: dict, copies: list, sms: int, blocks_of=None):
    """A launcher of the side's bf16 ragged call at 192 over page copy i."""
    wg = hasattr(lib, "opsagent_paged_ragged_attention_mla")
    p, i = ctypes.c_void_p, ctypes.c_int
    if wg:
        lib.opsagent_paged_ragged_attention_mla.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float, p]
        blocks = (blocks_of or pa.mla_blocks)(sms)
        ws = torch.empty(pa.mla_workspace_bytes(blocks) // 4, device="cuda")
    else:
        lib.opsagent_paged_ragged_attention.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, i, p]
    q, table, start, ql = c["q"], c["table"], c["start"], c["q_lens"]
    B, S = q.shape[:2]
    out = torch.empty_like(q)

    def launch(n):
        k, v = copies[n % len(copies)]
        s = stream(q.device)
        if wg:
            rc = lib.opsagent_paged_ragged_attention_mla(
                ptr(q), ptr(k), ptr(v), ptr(table), ptr(start), ptr(ql), ptr(ws), ptr(out),
                B, S, H, H, P, table.shape[1], blocks, D ** -0.5, s)
        else:
            rc = lib.opsagent_paged_ragged_attention(
                ptr(q), ptr(k), ptr(v), None, None, ptr(table), ptr(start), ptr(ql), ptr(out),
                B, S, H, H, D, P, table.shape[1], D ** -0.5, 1, s)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return out
    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base_csrc")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", nargs="*", default=[*VARIANTS, *RUNTIME])
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    jobs = [("base", copy_sources("base", args.base_csrc)), ("new", copy_sources("new", str(CSRC)))]
    jobs += [(v, copy_sources(v, str(CSRC), VARIANTS[v])) for v in args.variants if v in VARIANTS]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip([n for n, _ in jobs], ex.map(build, jobs)))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    starts, q_lens = [3968, 0, 5, 1000, 3001, 0, 200, 17], [128, 128, 0, 1, 77, 1, 128, 33]
    c = cs.make_case(gen, 8, 128, H, H, D, P, starts, q_lens, torch.bfloat16)
    c["v"][..., V_DIM:] = 0
    copies = cs.page_copies(c)
    want = pa.paged_ragged_attention_cuda(c["q"], c["k"], c["v"], c["table"], c["start"],
                                          c["q_lens"], plain=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = {n: ctypes.CDLL(path) for n, (path, _) in built.items()}
    sides = {n: side_fn(libs[n], c, copies, sms) for n in libs}
    sides.update({v: side_fn(libs["new"], c, copies, sms, RUNTIME[v])
                  for v in args.variants if v in RUNTIME})
    rows = {n: {"side": n, **built.get(n, (None, {}))[1], "ms": []} for n in sides}
    for n, fn in sides.items():
        got = fn(0)
        torch.cuda.synchronize()
        rows[n]["max_abs_err"] = (got.float() - want.float()).abs().max().item()
    order = ["base", "new", "new", "base"] + [v for v in sides if v not in ("base", "new")]
    for _ in range(args.rounds):
        for n in order:
            rows[n]["ms"].append(cs.graph_ms(sides[n]))
    sdpa = cs.ragged_sdpa(c)
    bound = cs.attention_bound_ms(c, 2)
    extra = {"sdpa_ms": cs.graph_ms(lambda i: sdpa()), "bound_ms": bound[0], "bound_by": bound[1],
             "tol": cs.TOL[torch.bfloat16]}
    for r in rows.values():
        r["median_ms"] = statistics.median(r["ms"])
        print(json.dumps(r), flush=True)
    print(json.dumps(extra))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    with open(os.path.join(OUT, "ab_mla.json"), "w") as f:
        json.dump({"rows": list(rows.values()), **extra, "card": smi}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
