#!/usr/bin/env python3
"""The quantized matmul's kernel against an earlier version of its source,
in one call on the GPU.

    python3 scripts/ab_quant_matmul.py BASE_SOURCE [--rounds N]

``BASE_SOURCE`` is an earlier ``quant_matmul.cu``, for example from the
parent commit unpacked with ``git archive`` under ``build/``. Both it and
``opsagent_tpu_torch/csrc/quant_matmul.cu`` are built with nvcc (``-I`` the
current shared headers) and bound through ctypes; an entry point from
before the ``splits`` and ``workspace`` arguments is bound with its own
signature. Each shape is timed through both by CUDA graph replay
(``chip_smoke.graph_ms``), in the order base, new, new, base, ``N`` rounds
(default 2), each weight rotated over copies that pass 100 MB as in
``chip_smoke.py``: the mixed ticks' shapes of bench-8b on the m128
instance, and ``wg`` at a decode step on the m16 instance (which at the
base may be an older kernel under the same name). int8 and int4 with one
whole-axis group. Prints one line per (shape, width) with every time of
both sides and their medians, then the card's name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opsagent_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from opsagent_tpu_torch.ops.cuda_build import CSRC, _nvcc, ptr, stream  # noqa: E402

OUT = os.path.join(ROOT, "build", "ab_qmm")
SHAPES = (  # (label, In, Out, T, instance)
    ("wg/wu", 4096, 14336, 1024, "m128"), ("wd", 14336, 4096, 1024, "m128"),
    ("wq/wo", 4096, 4096, 1024, "m128"), ("wk/wv", 4096, 1024, 1024, "m128"),
    ("wg/wu", 4096, 14336, 128, "m128"), ("wd", 14336, 4096, 128, "m128"),
    ("wg/wu", 4096, 14336, 8, "m16"),
)
MODES = (("int8", 8, 0), ("int4 G=1", 4, 0))


def build(name: str, src: str) -> tuple[ctypes.CDLL, bool]:
    """The library of ``src`` and whether its entry point takes splits."""
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, f"lib_{name}.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc {name}:\n{res.stderr[-3000:]}")
    split = "int splits" in open(src).read()
    loaded = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    loaded.opsagent_quant_matmul.argtypes = [p] * 4 + [i] * (9 if split else 8) + [p] * (
        2 if split else 1)
    loaded.opsagent_quant_matmul.restype = i
    return loaded, split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="an earlier quant_matmul.cu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_quant_matmul: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sources = {"base": os.path.abspath(args.base), "new": str(CSRC / "quant_matmul.cu")}
    with ThreadPoolExecutor(2) as ex:
        libs = dict(zip(sources, ex.map(lambda kv: build(*kv), sources.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, In, Out, T, instance in SHAPES:
        for mode, bits, group in MODES:
            w = cs.quantized_weight(gen, In, Out, bits, group)
            copies = [w] + [cs.quantized_weight(gen, In, Out, bits, group)
                            for _ in range(math.ceil(cs.ROTATE_BYTES / w.q.numel()) - 1)]
            x = (torch.randn(T, In, generator=gen, device="cuda")
                 / w.dequantize().norm(dim=0).mean()).bfloat16()
            want = qm.quant_matmul(x, w)
            block_n = qm.plan(T, In, Out, bits, qm._group(w), x.dtype, sms)[1]
            splits = qm.split_k(T, In, Out, block_n, sms) if instance == "m16" else 1
            launches = {}
            for side, (lib, split) in libs.items():
                y = torch.empty(T, Out, dtype=x.dtype, device="cuda")
                ws = torch.zeros(splits * T * Out + Out // 16, device="cuda")

                def launch(i, lib=lib, split=split, y=y, ws=ws, side=side):
                    c = copies[i % len(copies)]
                    tail = (splits, ptr(ws)) if split else ()
                    rc = lib.opsagent_quant_matmul(
                        ptr(x), ptr(c.q), ptr(c.scale), ptr(y), T, In, Out, bits,
                        qm._group(c), 1, qm.INSTANCES[instance], block_n, *tail,
                        stream(x.device))
                    if rc:
                        raise SystemExit(f"{side} {label} T={T} {mode}: CUDA error {rc}")

                launch(0)
                torch.cuda.synchronize()
                err = (y.float() - want.float()).abs().max().item()
                if err > cs.MM_TOL[x.dtype] * (1 + want.float().abs().max().item()):
                    raise SystemExit(f"{side} {label} T={T} {mode}: max err {err}")
                launches[side] = launch
            times = {"base": [], "new": []}
            for _ in range(args.rounds):
                for side in ("base", "new", "new", "base"):
                    times[side].append(cs.graph_ms(launches[side]))
            print(json.dumps({"shape": label, "T": T, "mode": mode, "instance": instance,
                              "block_n": block_n, "splits": splits, "ms": times,
                              "median_ms": {s: statistics.median(v) for s, v in times.items()}}),
                  flush=True)
            del copies, w, x, want, launches
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
