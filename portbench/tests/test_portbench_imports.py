"""What the benchmark loads: the runner's whole import graph (the port's
engine, scheduler and profiling included, as ``run_cell`` imports them)
loads no ``jax``, ``jaxlib``, ``flax`` or ``opsagent_tpu`` (top-level names
compared whole: the port's own name begins with the last), and the
reference side loads nothing of the port at all. Each check runs in a
fresh interpreter, since this test process may hold anything. Every cell
of ``BENCHMARK.json`` resolves to its configuration, mix, metric readers
and family modules."""

import json
import os
import subprocess
import sys

import pytest

from portbench import spec
from portbench.run import FORBIDDEN, ROOT

PROBE = """
import sys
{imports}
print(" ".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set[str]:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_runner_loads_no_jax_and_not_the_jax_package():
    names = loaded(
        "import portbench.run, portbench.control, portbench.trace, portbench.spec\n"
        "from portbench.run import ROOT\n"
        "cells = [w['name'] for w in __import__('json').load(open(ROOT / 'BENCHMARK.json'))['workloads']]\n"
        "for w in cells:\n"
        "    c = portbench.spec.load(ROOT, w)\n"
        "    [c.family(k) for k in ('reference', 'costs', 'adapters')]\n"
        "from opsagent_tpu_torch import obs\n"
        "from opsagent_tpu_torch.serving.engine import Engine, EngineConfig\n"
        "from opsagent_tpu_torch.serving.scheduler import Request, Scheduler\n"
        "from opsagent_tpu_torch.utils import profiling\n")
    assert "opsagent_tpu_torch" in names and "portbench" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_side_loads_nothing_of_the_port():
    names = loaded(
        "import portbench.reference.common, portbench.reference.qwen2, "
        "portbench.reference.deepseek_v2, portbench.judge, portbench.weights, "
        "portbench.generator, portbench.costs.qwen2, portbench.costs.deepseek_v2")
    assert "torch" in names
    assert not names & (set(FORBIDDEN) | {"opsagent_tpu_torch"})


@pytest.mark.parametrize(
    "workload", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.load(ROOT, workload)
    assert cell.config["family"] and cell.mix["clients"] > 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    reported = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(cell.readers[m["name"]].read)
    for kind in ("reference", "costs", "adapters"):
        assert cell.family(kind)
