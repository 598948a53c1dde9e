#!/usr/bin/env python3
"""How far two summation orders part a train step's gradients, on the GPU.

    python3 scripts/train_grad_noise.py [--seed 0]

One f32 step of bench-1b cut to 4 layers (``chip_smoke.py``'s
``train_parallel`` check: 4 x 256 tokens, lr 1e-3) at one rank, then at
dp = 2 over gloo (two ranks of this script sharing the card). Prints per
tensor the largest (clipped) gradient, the largest difference between the
two runs' gradients and parameters, and at the element that parts most the
two gradients and AdamW's r = |g| / (|g| + eps) of each run: where a
gradient cancels to summation noise, AdamW's first step turns that noise
into up to lr of the update (``opsagent_tpu_torch/training/parity.py``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opsagent_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: E402
from opsagent_tpu_torch.training import init_train_state, make_train_step  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                   "train_grad_noise")
KEYS = ("embed", "lm_head", "layers.0.wo", "layers.3.wd")


def step(seed: int, shape: dict | None, tag: str) -> None:
    """One step at ``shape`` (None: one rank); the keys' parameters before
    and after and their gradients, written to ``OUT/<tag>.pt``."""
    cfg, tc = cs.tp_config("bench1b"), cs.tp_train_config({})
    mesh = {} if shape is None else {"mesh": make_mesh(tp=1, **shape)}
    model, opt = init_train_state(cfg, tc, seed=seed, dtype=torch.float32, device="cuda",
                                  **mesh)
    params = dict(model.named_parameters())
    before = {k: params[k].detach().cpu().clone() for k in KEYS}
    m = make_train_step(cfg, tc)(model, opt, *cs.tp_batch(seed, cfg, cs.TP_F32_BATCH))
    torch.save({"metrics": {k: float(v) for k, v in m.items()}, "before": before,
                "after": {k: params[k].detach().cpu() for k in KEYS},
                "grad": {k: params[k].grad.detach().cpu() for k in KEYS}},
               os.path.join(OUT, f"{tag}.pt"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.rank >= 0:
        init_distributed(f"127.0.0.1:{args.port}", 2, args.rank, backend="gloo")
        step(args.seed, {"dp": 2}, f"dp2_{args.rank}")
        return 0
    if not torch.cuda.is_available():
        print("train_grad_noise: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    step(args.seed, None, "one")
    torch.cuda.empty_cache()
    port = cs.free_port()
    ranks = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed",
                               str(args.seed), "--rank", str(r), "--port", str(port)])
             for r in range(2)]
    if any(p.wait(timeout=600) for p in ranks):
        return 1
    one, dp = (torch.load(os.path.join(OUT, f"{t}.pt")) for t in ("one", "dp2_0"))
    print("metrics one rank", one["metrics"], "dp = 2", dp["metrics"])
    lr, wd, eps = 1e-3, 0.01, 1e-8
    for k in KEYS:
        diff = (dp["after"][k] - one["after"][k]).abs()
        i = tuple(int(x) for x in torch.unravel_index(diff.argmax(), diff.shape))
        r = {t: ((run["after"][k] - run["before"][k] * (1 - lr * wd)).abs() / lr)[i].item()
             for t, run in (("one", one), ("dp2", dp))}
        print(f"{k}: largest gradient {one['grad'][k].abs().max().item():.3e}, gradients "
              f"part by {(dp['grad'][k] - one['grad'][k]).abs().max().item():.3e}, "
              f"parameters by {diff.max().item():.3e} at {list(i)}: gradient "
              f"{one['grad'][k][i].item():.3e} / {dp['grad'][k][i].item():.3e}, "
              f"r {r['one']:.3f} / {r['dp2']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
