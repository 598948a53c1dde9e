#!/usr/bin/env python3
"""What rounding the softmax probabilities P to bf16 costs a bf16 attention
output, emulated on the CPU.

    python3 scripts/emulate_p_rounding.py [--seeds 4]

The tensor-core P.V product takes P as bf16 A fragments. This script
computes ragged causal attention at ``chip_smoke.py``'s timed S = 128 shape
(bench-8b width: H 32, K 8, D 128; contexts up to 4096) from bf16 inputs,
once with P in f32 (as the plain version), once with P rounded to one bf16
and once as hi + lo bf16 halves (hi = bf16(p), lo = bf16(p - hi)), and
prints, per seed, each one's largest difference from the exact result
after both are rounded to bf16, beside the bf16 tolerance of 1e-2, and how
many outputs have |out| >= 2 (where one bf16 ulp is 0.0156).
"""

from __future__ import annotations

import argparse
import json

import torch

H, K, D = 32, 8, 128
STARTS = [3968, 0, 5, 1000, 3001, 0, 200, 17]
Q_LENS = [128, 128, 0, 1, 77, 1, 128, 33]


def worst_errors(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    G = H // K
    worst = {"p_f32": 0.0, "p_bf16": 0.0, "p_hi_lo": 0.0}
    large = 0
    for start, q_len in zip(STARTS, Q_LENS):
        if q_len == 0:
            continue
        T = start + q_len
        q = torch.randn(q_len, H, D, generator=gen).bfloat16().float()
        k = torch.randn(T, K, D, generator=gen).bfloat16().float().repeat_interleave(G, dim=1)
        v = torch.randn(T, K, D, generator=gen).bfloat16().float().repeat_interleave(G, dim=1)
        s = torch.einsum("shd,thd->hst", q * D ** -0.5, k)
        visible = torch.arange(T)[None, None, :] <= start + torch.arange(q_len)[None, :, None]
        s = s.masked_fill(~visible, float("-inf"))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        exact = torch.einsum("hst,thd->hsd", p.double(), v.double()) / l.double()
        want = exact.float().bfloat16().float()
        large += int((exact.abs() >= 2).sum())
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        for name, pp in (("p_f32", p), ("p_bf16", hi), ("p_hi_lo", hi + lo)):
            got = (torch.einsum("hst,thd->hsd", pp, v) / l).bfloat16().float()
            worst[name] = max(worst[name], (got - want).abs().max().item())
    return {"seed": seed, **worst, "tol": 1e-2, "outputs_abs_ge_2": large}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    for seed in range(ap.parse_args().seeds):
        print(json.dumps(worst_errors(seed)), flush=True)


if __name__ == "__main__":
    main()
