#!/usr/bin/env python3
"""Where the time of the quantized matmul's staged instances goes, on the GPU.

    python3 scripts/ablate_quant_matmul.py [variant ...]

Copies ``opsagent_tpu_torch/csrc/quant_matmul.cu`` once per variant into
``build/ablate_qmm/``, edits the copy of the staged kernels
(``qmm_m128_kernel``, ``qmm_m16_kernel`` and the stage functions they
share) so that they take one part away or are shaped another way, builds
every variant in parallel (``-I`` the shared headers), and times it
through the C entry point: the m128 instance at the mixed
ticks' shapes of bench-8b (``wg`` and ``wd`` at T = 1024, ``wq`` and ``wk``
at T = 1024, ``wg`` at T = 128), the m16 instance at every served shape at
a decode step (T = 8), int8 and int4 with one whole-axis group, each
weight rotated over copies that pass 100 MB as in ``chip_smoke.py``. Times
are device times (``chip_smoke.graph_ms``). The m16 rows take the block
columns and splits of ``plan`` and ``split_k``; for ``base`` also the
other block width and half and twice the splits. A variant that takes a
part away computes wrong numbers: only the variants that keep the function
are checked against the plain version. Prints one line per (variant,
shape, width, block columns, splits) and the card's name; writes
``build/ablate_qmm/ablate_quant_matmul.json``.

Variants (all by default):
  base          the kernel as it is;
  no_dequant    the stage's codes are not dequantized (the bf16 tile keeps
                whatever it holds);
  no_mma        no tensor-core product (the fragments are still loaded);
  warps_2x2     4 warps of 64 x 64 tiles a block instead of 8 of 64 x 32;
  block_n256    128 x 256 blocks (8 warps of 64 x 64, one block an SM);
  double_tile   two bf16 weight tiles: stage s + 1 is dequantized beside
                stage s's products, one barrier a stage;
  stages4       m128: a ring of 4 stages (one block an SM at 128 columns);
  m16_stages3   m16: a ring of 3 stages (four blocks an SM).
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
    *((label, In, Out, 8) for label, (In, Out) in cs.MM_SHAPES.items()),
)
MODES = (("int8", 8, 0), ("int4 G=1", 4, 0))

_MMA = ("        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);\n"
        "        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);\n")
_DEQUANT = ("    dequantize_stage<{rows}, BITS, BN>(slot, ws, s * kStageK, In, group, s8, tid);\n"
            "    __syncthreads();  // the bf16 weight tile is written\n")
_LOOP = """  issue(0);
  cp_async_commit();
  if (stages > 1) issue(1);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<1>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 fully consumed
    if (s + 2 < stages) issue(s + 2);  // into the slot stage s - 1 held
    cp_async_commit();
    const unsigned char* slot = smem + (s % C::STAGES) * L::STAGE;
    dequantize_stage<128, BITS, BN>(slot, ws, s * kStageK, In, group, s8, tid);
    __syncthreads();  // the bf16 weight tile is written
    stage_products<128, BITS, BN>(acc, reinterpret_cast<const __nv_bfloat16*>(slot), ws, wm, wn,
                                  lane);
"""
_LOOP_DOUBLE = """  issue(0);
  cp_async_commit();
  if (stages > 1) issue(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  dequantize_stage<128, BITS, BN>(smem, ws, 0, In, group, s8, tid);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    if (s + 2 < stages) issue(s + 2);
    cp_async_commit();
    if (s + 1 < stages)
      dequantize_stage<128, BITS, BN>(smem + ((s + 1) % C::STAGES) * L::STAGE,
                                      ws + ((s + 1) & 1) * kStageK * L::LDB, (s + 1) * kStageK,
                                      In, group, s8, tid);
    const unsigned char* slot = smem + (s % C::STAGES) * L::STAGE;
    stage_products<128, BITS, BN>(acc, reinterpret_cast<const __nv_bfloat16*>(slot),
                                  ws + (s & 1) * kStageK * L::LDB, wm, wn, lane);
"""
_256 = "      if (block_n == 128)\n        return launch_m128<BITS, 128>"
VARIANTS = {  # name: (edits of quant_matmul.cu, block_n or None for the plan's, keeps the function)
    "base": ([], None, True),
    "no_dequant": ([(_DEQUANT.format(rows=rows), "    __syncthreads();\n") for rows in (128, 16)],
                   None, False),
    "no_mma": ([(_MMA, "        acc[mt][2 * np][0] += __uint_as_float(b[0] & a[mt][0] & 1u);\n")],
               None, False),
    "warps_2x2": ([("static constexpr int WN = 4;", "static constexpr int WN = ROWS == 128 ? 2 : 4;")],
                  None, True),
    "block_n256": ([("__launch_bounds__(Staged<128>::THREADS, Staged<128>::MIN_BLOCKS) qmm_m128_kernel",
                     "__launch_bounds__(Staged<128>::THREADS, BN == 256 ? 1 : 2) qmm_m128_kernel"),
                    (_256, "      if (block_n == 256)\n        return launch_m128<BITS, 256>"
                           "(x, q, scale, y, T, In, Out, group, stream);\n" + _256)],
                   256, True),
    "double_tile": ([("static constexpr int SMEM = Staged<ROWS>::STAGES * STAGE + kStageK * LDB * 2;",
                      "static constexpr int SMEM = Staged<ROWS>::STAGES * STAGE + 2 * kStageK * LDB * 2;"),
                     (_LOOP, _LOOP_DOUBLE)],
                    None, True),
    "stages4": ([("static constexpr int STAGES = ROWS == 128 ? 3 : 4;",
                  "static constexpr int STAGES = ROWS == 128 ? 4 : 4;")], None, True),
    "m16_stages3": ([("static constexpr int STAGES = ROWS == 128 ? 3 : 4;",
                      "static constexpr int STAGES = 3;"),
                     ("static constexpr int MIN_BLOCKS = ROWS == 128 ? 2 : 3;",
                      "static constexpr int MIN_BLOCKS = ROWS == 128 ? 2 : 4;")], None, True),
}


def edited_source(name: str) -> str:
    """``quant_matmul.cu`` with variant ``name``'s edits."""
    edits, _, _ = VARIANTS[name]
    text = open(os.path.join(CSRC, "quant_matmul.cu")).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"quant_matmul.cu changed: variant {name} cannot find {old!r}")
        text = text.replace(old, new)
    return text


def build(name: str) -> str:
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(edited_source(name))
    lib = os.path.join(OUT, f"lib_{name}.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc {name}:\n{res.stderr[-3000:]}")
    return lib


def configs(name: str, T: int, In: int, Out: int, plan_n: int, sms: int) -> list[tuple[int, int]]:
    """(block columns, splits) at which variant ``name`` is timed."""
    block_n = VARIANTS[name][1] or plan_n
    if T > 16:
        return [(block_n, 1)]
    if name != "base":
        return [(block_n, qm.split_k(T, In, Out, block_n, sms))]
    out = []
    for width in (plan_n, 192 - plan_n):  # 128 and 64, the plan's first
        s = qm.split_k(T, In, Out, width, sms)
        most = max(1, -(-In // qm.STAGE_ROWS) // 2)
        out += [(width, k) for k in sorted({max(1, s // 2), s, min(2 * s, most)})]
    return out


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
            instance, plan_n = qm.plan(T, In, Out, bits, qm._group(w), x.dtype, sms)
            for name, lib in libs.items():
                keeps = VARIANTS[name][2]
                for block_n, splits in configs(name, T, In, Out, plan_n, sms):
                    y = torch.empty(T, Out, dtype=x.dtype, device="cuda")
                    ws = torch.zeros(splits * T * Out + Out // 16, device="cuda")

                    def launch(i, lib=lib, block_n=block_n, splits=splits, y=y, ws=ws):
                        c = copies[i % len(copies)]
                        rc = lib.opsagent_quant_matmul(
                            ptr(x), ptr(c.q), ptr(c.scale), ptr(y), T, In, Out, bits,
                            qm._group(c), 1, qm.INSTANCES[instance], block_n, splits,
                            ptr(ws), stream(x.device))
                        if rc:
                            raise SystemExit(f"{name} {label} T={T} {mode}: CUDA error {rc}")

                    launch(0)  # the first copy, the one ``want`` was computed from
                    torch.cuda.synchronize()
                    row = {"variant": name, "shape": label, "T": T, "mode": mode,
                           "instance": instance, "block_n": block_n, "splits": splits}
                    if keeps:
                        row["max_abs_err"] = (y.float() - want.float()).abs().max().item()
                    row["ms"] = cs.graph_ms(launch)
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    del y, ws
            del copies, w, x, want
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    with open(os.path.join(OUT, "ablate_quant_matmul.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
