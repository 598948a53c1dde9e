#!/usr/bin/env python3
"""The near-tie rule of ``chip_smoke.py``'s ``mla_materialized`` at
DeepSeek-V2-Lite's materialized cut (full width, 2 layers, bf16), on the
port of a given checkout, on the GPU:

    python3 scripts/mla_near_tie.py [ROOT ...]

Each ROOT (default: this checkout) holds the ``opsagent_tpu_torch`` to run,
for example an earlier commit unpacked with ``git archive`` under
``build/``; each runs in a process of its own with ROOT first on the path,
through this checkout's ``chip_smoke.py`` (``e2e_prompts``,
``mla_streams``, ``near_ties``). Prints one JSON line per ROOT: the kernel
path's and the plain path's greedy tokens, where each stream parts, and at
every step the plain path's top-2 logit margin and the kernel-vs-plain
logit difference; then the card's name.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from dataclasses import replace

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(cs.V2_LITE_MATERIALIZED, name=f"{cs.V2_LITE_MATERIALIZED.name}-2l",
                  num_layers=2)
    p0, p1, _ = cs.e2e_prompts(0)
    prompts = [[t % cfg.vocab_size for t in p] for p in (p0, p1)]
    model, toks, counts = cs.mla_streams(cfg, torch.bfloat16, 0, prompts)
    ties = cs.near_ties(model, prompts, toks["plain"])
    agreeing = cs.tokens_agreeing(toks["cuda"], toks["plain"])
    return {"root": root, "package": os.path.dirname(cs.pa.__file__),
            "launches": {k: v for k, v in counts.items() if v},
            "tokens": toks, "tokens_agreeing": agreeing,
            "rule_holds": [n >= t["first_tie"] for n, t in zip(agreeing, ties)],
            "near_ties": ties}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(run(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    rc = 0
    for root in sys.argv[1:] or [HERE]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root]).returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
