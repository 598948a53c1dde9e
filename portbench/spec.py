"""Finds what a cell is made of, by the names in ``BENCHMARK.json``: its
configuration file, its traffic mix (``traffic/<mix>.json``), its
``correct``'s limits and sample (``workloads/<cell>.json``), its
end-to-end metrics and the readers of its per-layer metrics
(``metrics/<metric>.py``, or the reader of the name's part before its
first dot, so that ``mfu.ttft`` and ``mfu.tput`` share ``metrics/mfu.py``),
and the modules of its model family. A later cell, configuration, mix or
metric is new files and new entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file
    mix: dict               # the traffic mix's parameters
    check: dict             # "limits": each number ``correct`` compares and its
                            # limit; "tokens": the sample's served tokens
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict[str, ModuleType] = field(default_factory=dict)

    def family(self, kind: str) -> ModuleType:
        """``reference``, ``costs`` or ``adapters`` module of the family."""
        return importlib.import_module(f"{__package__}.{kind}.{self.config['family']}")


def _by_name(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def _reader(data: Path, metric: str) -> ModuleType:
    for stem in (metric, metric.split(".", 1)[0]):
        path = data / "metrics" / f"{stem}.py"
        if path.is_file():
            mod_name = f"{__package__}.metrics._{stem.replace('.', '_').replace('-', '_')}"
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise KeyError(f"no reader for the metric {metric!r} under {data / 'metrics'}")


def load(root: Path, workload: str, data: Path | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; traffic mixes,
    cells' limits and readers are looked up under ``data`` (default: this
    package)."""
    data = data or PKG
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _by_name(bench["workloads"], workload, "workload")
    c = _by_name(bench["configs"], w["config"], "configuration")
    config = json.loads((root / c["file"]).read_text())
    mix = json.loads((data / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    check = json.loads((data / "workloads" / f"{workload}.json").read_text())
    cell = Cell(workload, int(w["chips"]), config, mix, check, e2e, per_layer)
    cell.readers = {m["name"]: _reader(data, m["name"]) for m in per_layer}
    return cell
