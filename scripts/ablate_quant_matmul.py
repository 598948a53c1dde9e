#!/usr/bin/env python3
"""Where the time of the quantized matmul's m128 instance goes, on the GPU.

    python3 scripts/ablate_quant_matmul.py [variant ...]

Copies ``opsagent_tpu_torch/csrc/quant_matmul.cu`` once per variant into
``build/ablate_qmm/``, edits the copy of ``qmm_m128_kernel`` so that it
takes one part away or is shaped another way, builds every variant in
parallel (``-I`` the shared headers), and times the m128 instance through
the C entry point at the mixed ticks' shapes of bench-8b (``wg`` and ``wd``
at T = 1024, ``wq`` and ``wk`` at T = 1024, ``wg`` at T = 128), int8 and
int4 with one whole-axis group, each weight rotated over copies that pass
100 MB as in ``chip_smoke.py``. A variant that takes a part away computes
wrong numbers: only the variants that keep the function are checked
against the plain version. Prints one line per (variant, shape, width) and
the card's name; writes ``build/ablate_qmm/ablate_quant_matmul.json``.

Variants (all by default):
  base          the kernel as it is;
  no_dequant    the stage's codes are not dequantized (the bf16 tile keeps
                whatever it holds);
  no_mma        no tensor-core product (the fragments are still loaded);
  warps_2x2     4 warps of 64 x 64 tiles a block instead of 8 of 64 x 32;
  block_n256    128 x 256 blocks (8 warps of 64 x 64, one block an SM);
  double_tile   two bf16 weight tiles: stage s + 1 is dequantized beside
                stage s's products, one barrier a stage;
  stages4       a ring of 4 stages (one block an SM at 128 columns).
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opsagent_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from opsagent_tpu_torch.ops.cuda_build import CSRC, _nvcc, ptr, stream  # noqa: E402

OUT = os.path.join(ROOT, "build", "ablate_qmm")
SHAPES = (  # (label, In, Out, T)
    ("wg/wu", 4096, 14336, 1024), ("wd", 14336, 4096, 1024), ("wq/wo", 4096, 4096, 1024),
    ("wk/wv", 4096, 1024, 1024), ("wg/wu", 4096, 14336, 128),
)
MODES = (("int8", 8, 0), ("int4 G=1", 4, 0))

_MMA = ("          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);\n"
        "          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);\n")
_LOOP = """  issue(0);
  cp_async_commit();
  if (stages > 1) issue(1);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<1>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 fully consumed
    if (s + 2 < stages) issue(s + 2);  // into the slot stage s - 1 held
    cp_async_commit();
    dequantize(s);
    __syncthreads();  // the bf16 weight tile is written
"""
_LOOP_DOUBLE = """  issue(0);
  cp_async_commit();
  if (stages > 1) issue(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  dequantize(0, ws);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    if (s + 2 < stages) issue(s + 2);
    cp_async_commit();
    if (s + 1 < stages) dequantize(s + 1, ws + ((s + 1) & 1) * kM128K * L::LDB);
    const __nv_bfloat16* wsb = ws + (s & 1) * kM128K * L::LDB;
"""
_B_READ = "ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 15)) * L::LDB"
_256 = "      if (block_n == 128)\n        return launch_m128<BITS, 128>"
VARIANTS = {  # name: (edits of quant_matmul.cu, block_n or None for the plan's, keeps the function)
    "base": ([], None, True),
    "no_dequant": ([("    dequantize(s);\n    __syncthreads();  // the bf16 weight tile is written\n",
                     "    __syncthreads();\n")], None, False),
    "no_mma": ([(_MMA, "          acc[mt][2 * np][0] += __uint_as_float(b[0] & a[mt][0] & 1u);\n")],
               None, False),
    "warps_2x2": ([("constexpr int kM128Threads = 256;", "constexpr int kM128Threads = 128;"),
                   ("constexpr int WTN = BN / 4, NT = WTN / 8;", "constexpr int WTN = BN / 2, NT = WTN / 8;"),
                   ("const int wm = warp / 4, wn = warp % 4;", "const int wm = warp / 2, wn = warp % 2;")],
                  None, True),
    "block_n256": ([("__launch_bounds__(kM128Threads, 2) qmm_m128_kernel",
                     "__launch_bounds__(kM128Threads, BN == 256 ? 1 : 2) qmm_m128_kernel"),
                    (_256, "      if (block_n == 256)\n        return launch_m128<BITS, 256>"
                           "(x, q, scale, y, T, In, Out, group, stream);\n" + _256)],
                   256, True),
    "double_tile": ([("static constexpr int SMEM = kM128Stages * STAGE + kM128K * LDB * 2;",
                      "static constexpr int SMEM = kM128Stages * STAGE + 2 * kM128K * LDB * 2;"),
                     ("auto dequantize = [&](int s) {", "auto dequantize = [&](int s, __nv_bfloat16* ws) {"),
                     (_LOOP, _LOOP_DOUBLE), (_B_READ, _B_READ.replace("(b, ws +", "(b, wsb +"))],
                    None, True),
    "stages4": ([("constexpr int kM128Stages = 3;", "constexpr int kM128Stages = 4;")], None, True),
}


def build(name: str) -> str:
    edits, _, _ = VARIANTS[name]
    text = open(os.path.join(CSRC, "quant_matmul.cu")).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"quant_matmul.cu changed: variant {name} cannot find {old!r}")
        text = text.replace(old, new)
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib_{name}.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc {name}:\n{res.stderr[-3000:]}")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_quant_matmul: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(build, names)))
    libs = {name: ctypes.CDLL(path) for name, path in libs.items()}
    for lib in libs.values():
        qm._bind(lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, In, Out, T in SHAPES:
        for mode, bits, group in MODES:
            w = cs.quantized_weight(gen, In, Out, bits, group)
            copies = [w] + [cs.quantized_weight(gen, In, Out, bits, group)
                            for _ in range(math.ceil(cs.ROTATE_BYTES / w.q.numel()) - 1)]
            x = (torch.randn(T, In, generator=gen, device="cuda")
                 / w.dequantize().norm(dim=0).mean()).bfloat16()
            want = qm.quant_matmul(x, w)
            _, plan_n = qm.plan(T, In, Out, bits, qm._group(w), x.dtype, sms)
            for name, lib in libs.items():
                _, fixed_n, keeps = VARIANTS[name]
                block_n = fixed_n or plan_n
                y = torch.empty(T, Out, dtype=x.dtype, device="cuda")

                def launch(i, lib=lib, block_n=block_n, y=y):
                    c = copies[i % len(copies)]
                    rc = lib.opsagent_quant_matmul(
                        ptr(x), ptr(c.q), ptr(c.scale), ptr(y), T, In, Out, bits, qm._group(c),
                        1, qm.INSTANCES["m128"], block_n, stream(x.device))
                    if rc:
                        raise SystemExit(f"{name} {label} T={T} {mode}: CUDA error {rc}")

                launch(0)  # the first copy, the one ``want`` was computed from
                torch.cuda.synchronize()
                row = {"variant": name, "shape": label, "T": T, "mode": mode, "block_n": block_n}
                if keeps:
                    row["max_abs_err"] = (y.float() - want.float()).abs().max().item()
                row["ms"] = cs.time_ms(launch, iters=30)
                rows.append(row)
                print(json.dumps(row), flush=True)
            del copies, w, x, want
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    with open(os.path.join(OUT, "ablate_quant_matmul.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
