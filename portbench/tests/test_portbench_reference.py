"""Each family's plain reference against the port's own plain forward at a
tiny size on the CPU, on the benchmark's seeded weights written into the
port by ``adapters`` (so the mapping of names and layouts is held too).
The reference module itself imports nothing of the port; this test
imports both."""

import importlib

import pytest
import torch

from portbench.tests import tiny
from portbench.weights import Maker


@pytest.mark.parametrize("family", sorted(tiny.FAMILIES))
def test_reference_equals_the_ports_plain_forward(family):
    from opsagent_tpu_torch.models.llama import Llama

    conf = tiny.FAMILIES[family]()
    ref = importlib.import_module(f"portbench.reference.{family}")
    adapter = importlib.import_module(f"portbench.adapters.{family}")
    cfg = tiny.port_config(conf)
    adapter.check(conf, cfg)
    maker = Maker(1234567891011, "cpu", torch.float32)
    model = Llama(cfg, torch.float32, "cpu", seed=None)
    adapter.load(model, conf, maker)
    tokens = torch.randint(0, 500, (37,), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        port = model.forward_full(tokens[None])[0]
        mine = ref.logits_at(conf, lambda sp: maker.make(sp).float(), [tokens.tolist()],
                             [list(range(37))], torch.device("cpu"))[0]
    assert port.shape == mine.shape
    # float32 both ways: summation order alone.
    assert (port - mine).abs().max().item() < 2e-4 * max(1.0, mine.abs().max().item())
    # and the logits are not degenerate
    assert mine.std().item() > 0.1


def test_a_preset_that_differs_from_the_file_is_refused():
    conf = tiny.qwen2()
    conf["rope_theta"] = 10000.0
    adapter = importlib.import_module("portbench.adapters.qwen2")
    with pytest.raises(ValueError, match="rope_theta"):
        adapter.check(conf, tiny.port_config(conf))
