#!/usr/bin/env python3
"""The MoE layer's weighted sum over experts, in its forms, on the GPU.

    python3 scripts/ab_moe_sum.py [--seed 0] [--rounds 2]

Builds one MoE layer of DeepSeek-V2-Lite at full width in bf16 (64 routed
experts, top-6, 2 shared; a 2-layer cut of the preset, random weights from
``--seed``) and times, by CUDA graph replay (``chip_smoke.graph_ms``), at a
decode step (T = 8 rows) and at a bucket-128 mixed tick (T = 1024):

- ``moe_mlp``: the layer's whole ``DecoderLayer.moe_mlp``;
- the weighted sum alone, over the same experts' outputs ``y [E, T, d]``:
  ``expert_loop``, JAX's scan (``out + c_e * y_e`` for each of the 64
  experts in order, in bf16); ``ordered_gather``, the same sum from the
  k selected experts sorted by index, their terms picked by advanced
  indexing, k - 1 bf16 adds; ``ordered_take``, the form ``moe_mlp`` runs,
  the same with ``torch.gather`` over ``y`` seen as ``[T, E, d]``; and
  ``f32_sum``, the weighted product over all experts reduced by
  ``.sum(0)`` (another order, f32 accumulation).

Each time is taken in the order of the list above, then again reversed,
``--rounds`` times. Prints one JSON line per T with every time and its
median, whether each form equals ``expert_loop`` bit for bit, and then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opsagent_tpu_torch.models.config import get_config_preset  # noqa: E402
from opsagent_tpu_torch.models.llama import Llama  # noqa: E402


def routing(layer, h, cfg):
    """(idx [T, k], vals [T, k] f32, y [E, T, d]) of the layer on h."""
    m = cfg.moe
    T, d = h.shape[0] * h.shape[1], h.shape[-1]
    probs = torch.softmax(h.float() @ layer.router, dim=-1).view(T, -1)
    idx = probs.topk(m.num_experts_per_token, dim=-1).indices
    vals = probs.gather(-1, idx)
    x = h.reshape(T, d)
    xe = x.expand(m.num_experts, *x.shape)
    y = torch.bmm(torch.nn.functional.silu(torch.bmm(xe, layer.eg))
                  * torch.bmm(xe, layer.eu), layer.ed)
    return idx, vals, y


def expert_loop(idx, vals, y):
    E, T, _ = y.shape
    combine = torch.zeros(T, E, device=y.device).scatter_(-1, idx, vals).T.to(y.dtype)
    out = torch.zeros_like(y[0])
    for e in range(E):
        out = out + combine[e, :, None] * y[e]
    return out


def ordered_gather(idx, vals, y):
    T, k = idx.shape
    order, perm = idx.sort(-1)
    c = vals.gather(-1, perm).to(y.dtype)
    terms = c[..., None] * y[order, torch.arange(T, device=y.device)[:, None]]
    out = terms[:, 0]
    for j in range(1, k):
        out = out + terms[:, j]
    return out


def ordered_take(idx, vals, y):
    T, k = idx.shape
    order, perm = idx.sort(-1)
    c = vals.gather(-1, perm).to(y.dtype)
    picked = y.transpose(0, 1).gather(1, order[..., None].expand(T, k, y.shape[-1]))
    terms = c[..., None] * picked
    out = terms[:, 0]
    for j in range(1, k):
        out = out + terms[:, j]
    return out


def f32_sum(idx, vals, y):
    E, T, _ = y.shape
    combine = torch.zeros(T, E, device=y.device).scatter_(-1, idx, vals).T.to(y.dtype)
    return (combine[..., None] * y).sum(0)


FORMS = {"expert_loop": expert_loop, "ordered_gather": ordered_gather,
         "ordered_take": ordered_take, "f32_sum": f32_sum}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_moe_sum: no CUDA device", file=sys.stderr)
        return 1
    base = get_config_preset("deepseek-v2-lite")
    cfg = dataclasses.replace(base, num_layers=2)
    model = Llama(cfg, torch.bfloat16, "cuda", seed=args.seed)
    layer = model.layers[cfg.moe_layer_start]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for B, S in ((8, 1), (8, 128)):
        h = torch.randn(B, S, cfg.hidden_size, generator=gen, device="cuda").bfloat16()
        with torch.inference_mode():
            idx, vals, y = routing(layer, h, cfg)
            want = expert_loop(idx, vals, y)
            equal = {name: bool(torch.equal(f(idx, vals, y), want))
                     for name, f in FORMS.items()}
            calls = {"moe_mlp": lambda i: layer.moe_mlp(h, cfg),
                     **{name: (lambda i, f=f: f(idx, vals, y)) for name, f in FORMS.items()}}
            times: dict[str, list[float]] = {name: [] for name in calls}
            for _ in range(args.rounds):
                for order in (list(calls), list(reversed(calls))):
                    for name in order:
                        times[name].append(cs.graph_ms(calls[name]))
        print(json.dumps({"T": B * S, "E": cfg.moe.num_experts,
                          "k": cfg.moe.num_experts_per_token, "d": cfg.hidden_size,
                          "ms": times,
                          "median_ms": {n: statistics.median(t) for n, t in times.items()},
                          "equal_to_expert_loop": equal}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
