"""The control of ``correct`` on the card, at each cell's own size: on
three seeds the program stays within the cell's limits, and the control
(the reference computed in fp8 in the program's place) fails one of
them on every seed. Card only:

    python -m pytest -m cuda portbench/tests/test_portbench_control.py
"""

import json

import pytest

from portbench.run import ROOT

SEEDS = [3100000007, 3100000019, 3100000031]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_where_the_program_passes(card, workload):
    from portbench.control import readings
    from portbench.run import set_cache_dirs

    set_cache_dirs(ROOT)
    rows = readings(workload, SEEDS, 30.0)
    for row in rows:
        assert row["correct"] and row["control_fails"], row
