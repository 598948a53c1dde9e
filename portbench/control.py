"""The control of ``correct``, run on the card at a cell's own size: for
each seed, one run of the cell as the benchmark makes it (set-up, window,
drain, sample), then the program's mean and widest gaps and the control's, the
reference computed in fp8 (``judge.fp8_control``) put in the program's
place, at the same prompts and positions. The limit of a cell is set
between the largest gap sound runs of the program read and the
smallest the control reads. The benchmark's own runs do not run it.

    python -m portbench.control --workload <name> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed."""

from __future__ import annotations

import argparse
import json

from .run import ROOT, run_cell, set_cache_dirs


def readings(workload: str, seeds: list[int], seconds: float) -> list[dict]:
    """One run a seed in this process: the program's mean and widest gaps,
    the control's, the cell's limits, and the numbers the control fails."""
    from . import spec

    cell = spec.load(ROOT, workload)
    out = []
    for seed in seeds:
        run = run_cell(cell, seed, seconds, False, control=True)
        limits = {k: lim for k, (_, lim) in run["compared"].items() if k.endswith("_logit_gap")}
        ctrl = {"mean_logit_gap": run["control"]["mean"], "max_logit_gap": run["control"]["max"]}
        row = {"workload": workload, "seed": seed,
               "program": run["info"]["logit_gap"]["mean"],
               "program_max": run["info"]["logit_gap"]["max"],
               "control": ctrl["mean_logit_gap"], "control_max": ctrl["max_logit_gap"],
               "limits": limits, "control_fails": sorted(k for k in limits if ctrl[k] > limits[k]),
               "correct": run["result"]["correct"],
               "attempted": run["result"]["attempted"], "info": run["info"]}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    readings(args.workload, args.seeds, args.seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
