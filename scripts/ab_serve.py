#!/usr/bin/env python3
"""One model's smoke serve from an earlier tree and from this one, traced,
in one call on the GPU.

    python3 scripts/ab_serve.py PARENT_TREE [--model deepseek-v2-lite] [--backend dma]

``PARENT_TREE`` is an earlier checkout, for example the parent commit
unpacked with ``git archive`` under ``build/``. Each side runs
``chip_smoke.phase_serve`` (random weights from seed 0, bf16, four
concurrent completions, the default loop then ``depth1``) in a process of
its own, with ``--profile``'s trace, the parent first. Both sides group the
trace's kernels by this tree's ``chip_smoke.KERNEL_GROUPS`` (before PR 16
the latent kernels were counted as dma rows). Prints, for each side, the
``profile`` line (device ms by kernel group over the traced window) and
the serve's device times (``decode_device_ms_per_step``,
``mixed_device_ms_per_tick``), tok/s and TTFT; each side's full output
goes to ``chiprun_out/serve_<side>.log``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# Run in the side's tree, with this tree's kernel groups.
CHILD = r'''
import json, os, sys
tree, groups, model, backend = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
cs.KERNEL_GROUPS = tuple((g, tuple(k)) for g, k in groups)
torch.backends.cuda.matmul.allow_tf32 = False
smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
r = cs.phase_serve(0, smi, True, model, backend, "", "")
keep = {k: r[k] for k in ("completion_tok_per_s", "ttft_p50_s", "decode_device_ms_per_step",
                          "mixed_device_ms_per_tick", "decode_floor_ms", "mixed_ticks",
                          "decode_steps") if k in r}
print("RESULT", json.dumps(keep), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="an earlier checkout of the repository")
    ap.add_argument("--model", default="deepseek-v2-lite")
    ap.add_argument("--backend", default="dma")
    args = ap.parse_args()
    groups = json.dumps([[g, list(k)] for g, k in cs.KERNEL_GROUPS])
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    rc = 0
    for side, tree in (("parent", os.path.abspath(args.parent)), ("new", ROOT)):
        res = subprocess.run([sys.executable, "-c", CHILD, tree, groups, args.model, args.backend],
                             capture_output=True, text=True, timeout=1500)
        with open(os.path.join(out, f"serve_{side}.log"), "w") as f:
            f.write(res.stdout + "\n" + res.stderr[-20000:])
        for line in res.stdout.splitlines():
            if line.startswith("RESULT") or '"phase": "profile"' in line:
                print(side, line, flush=True)
        if res.returncode:
            print(side, "failed", res.returncode, res.stderr[-1500:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
