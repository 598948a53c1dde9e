"""The harness driven end to end on the CPU at a tiny size (the look for a
card skipped): a tiny extra cell added from a temporary directory with
nothing but data files and a reader of its own; and the timed path broken
underneath, once for each fault a served cell can have, where ``correct``
must come out false."""

import json
import shutil

import pytest

from portbench import spec
from portbench.run import ROOT, run_cell
from portbench.tests import tiny

SEED = 2**31 + 99


@pytest.fixture(autouse=True)
def tiny_port(monkeypatch):
    """The port built at the tiny configurations' sizes."""
    monkeypatch.setattr("portbench.adapters.port_config", tiny.port_config)


# A cell of each family, whose limits a tiny run of that family is held to.
CELLS = {"qwen2": "qwen2.5-7b.agent", "deepseek_v2": "deepseek-v2-lite.longdoc"}


def tiny_cell(family: str = "qwen2"):
    cell = spec.load(ROOT, CELLS[family])
    cell.config, cell.mix = tiny.FAMILIES[family](), tiny.TINY_MIX
    return cell


NEW_READER = '''"""Dispatches the engine priced in the traced sub-window."""


def read(ctx):
    return float(len(ctx.comps_of(ctx.trace.occurrences))) or None
'''


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    data = tmp_path / "portbench"
    shutil.copytree(spec.PKG / "metrics", data / "metrics")
    (data / "metrics" / "dispatches.py").write_text(NEW_READER)
    (data / "traffic").mkdir()
    (data / "traffic" / "tiny_chat.json").write_text(json.dumps(tiny.TINY_MIX))
    (data / "workloads").mkdir()
    limits = {"limits": {"mean_logit_gap": 0.005}}
    (data / "workloads" / "tiny-qwen.chat.json").write_text(json.dumps(limits))
    (data / "configs").mkdir()
    (data / "configs" / "tiny-qwen.json").write_text(json.dumps(tiny.qwen2()))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny-qwen", "source": "test", "file": "portbench/configs/tiny-qwen.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny-qwen.chat", "config": "tiny-qwen", "traffic": "tiny_chat",
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    bench["per_layer"] = [
        {"name": "dispatches.tput", "unit": "1", "better": "higher", "source": "program_counter",
         "layer": "engine", "moves": "output_tok_s", "workloads": ["tiny-qwen.chat"]},
        {"name": "prefix_hit_share.ttft", "unit": "%", "better": "higher", "source": "program_counter",
         "layer": "prefix cache", "moves": "ttft_p90_ms"},
    ]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load(tmp_path, "tiny-qwen.chat", data=data)
    assert set(cell.readers) == {"dispatches.tput", "prefix_hit_share.ttft"}
    plain = run_cell(cell, SEED, 2.0, False, device="cpu")["result"]
    assert plain["correct"] and plain["attempted"] > 0
    assert set(plain["metrics"]) == {"output_tok_s", "ttft_p90_ms", "tpot_p90_ms", "setup_s"}
    traced = run_cell(cell, SEED, 3.0, True, device="cpu")["result"]
    assert traced["correct"] and traced["metrics"]["dispatches.tput"]["value"] > 0
    assert 0 < traced["metrics"]["prefix_hit_share.ttft"]["value"] <= 100
    assert list(traced)[-1] == "checks"


@pytest.mark.parametrize("family", sorted(tiny.FAMILIES))
def test_a_sound_run_is_correct(family):
    out = run_cell(tiny_cell(family), SEED, 2.0, False, device="cpu")
    assert out["result"]["correct"], out["compared"]
    assert out["info"]["checked_requests"] >= 4


def _alter_tokens(monkeypatch):
    from opsagent_tpu_torch.serving.engine import Engine

    accept = Engine._accept_token

    def altered(self, seq, token):
        if len(seq.tokens) % 3 == 1:
            token = (token + 1) % 500
        return accept(self, seq, token)

    monkeypatch.setattr(Engine, "_accept_token", altered)


def _drop_cache_writes(monkeypatch):
    from opsagent_tpu_torch.models.llama import PagedKVCache

    monkeypatch.setattr(PagedKVCache, "write", lambda self, *a, **k: None)


@pytest.mark.parametrize("fault", [_alter_tokens, _drop_cache_writes],
                         ids=["token_altered_where_produced", "cache_state_left_unchanged"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell(tiny_cell(), SEED, 2.0, False, device="cpu")
    assert not out["result"]["correct"]
    gap, limit = out["compared"]["mean_logit_gap"]
    assert gap > limit
