#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s phases alone, on the GPU.

    python3 scripts/chip_phases.py [--seed 0] [PHASE ...]

Builds the kernels (``phase_build``), then runs each named phase
(``phase_<PHASE>`` of ``chip_smoke.py``: e.g. ``prefill_lane``,
``autoscale``, ``fleet``; these three by default; ``parallel`` and
``train_parallel`` with ``--parallel-backend nccl`` put their two ranks on
two cards, where ``parallel`` also runs its tp = 2 check and its serve
with the steps captured as CUDA graphs around their NCCL collectives)
and prints
its JSON line,
as ``chip_smoke.py`` does, with the card's name and power limit. A phase
that fails prints its traceback and a ``failed`` line, and the next one
runs. Exits 1 when any phase failed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("phases", nargs="*", default=["prefill_lane", "autoscale", "fleet"])
    ap.add_argument("--parallel-backend", default=chip_smoke.PARALLEL_BACKEND,
                    help="the parallel phases' backend: gloo (two ranks on one card) "
                         "or nccl (a card a rank, on a machine with several)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    chip_smoke.phase_build()
    chip_smoke.emit({"phase": "build", "seconds": time.perf_counter() - t, "card": smi})
    failed = False
    for name in args.phases:
        t = time.perf_counter()
        try:
            extra = ({"backend": args.parallel_backend}
                     if name in ("parallel", "train_parallel") else {})
            out = getattr(chip_smoke, f"phase_{name}")(args.seed, smi, **extra)
            chip_smoke.emit({"phase": name, "seconds": time.perf_counter() - t, **out})
        except Exception as e:  # noqa: BLE001 - reported; the next phase runs
            traceback.print_exc()
            print(json.dumps({"phase": name, "failed": str(e)[:2000]}), flush=True)
            failed = True
        gc.collect()
        torch.cuda.empty_cache()
    print(smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
