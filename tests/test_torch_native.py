"""The port's native FSM matcher (``opsagent_tpu_torch.native``) against the
JAX package's (``opsagent_tpu.native``) and the numpy walk, on the CPU.

- Mask and destination rows of every DFA state equal the numpy walk's
  (``TokenFSM._walk``) and, through ``mask_for_state`` and ``advance``,
  JAX's ``NativeFSMTables``: the ReAct ToolPrompt schema at V = 512 (every
  state) and at the served width V = 128,256, the schemaless
  ``json_object`` at V = 512 (seeded samples of states there; JAX's
  destinations, a ctypes call a token, on fewer).
- ``TokenFSM`` takes the native tables exactly where JAX's does: within
  ``NATIVE_TABLE_BUDGET`` entries, at the default budget and at a cut one;
  host masks and advances answer from them as from the numpy walk.
- The library is built under the kernel build directory, named by its
  source's hash; a source that does not compile raises, and no
  environment switch turns the tables off.
"""

import functools

import numpy as np
import pytest

from opsagent_tpu import native as jnative
from opsagent_tpu.serving import constrained as jc
from opsagent_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from opsagent_tpu_torch import native
from opsagent_tpu_torch.ops import cuda_build
from opsagent_tpu_torch.serving import constrained as pc
from opsagent_tpu_torch.serving.tokenizer import ByteTokenizer

SCHEMAS = {"toolprompt": pc.TOOLPROMPT_SCHEMA, "json_object": None}


@functools.lru_cache(maxsize=None)
def _dfas(name):
    schema = SCHEMAS[name]
    return (jc.compile_regex(jc.schema_to_regex(schema)),
            pc.compile_regex(pc.schema_to_regex(schema)))


def _fsms(name, vocab):
    jdfa, pdfa = _dfas(name)
    jtok, ptok = JaxByteTokenizer(vocab), ByteTokenizer(vocab)
    return (jc.TokenFSM(jdfa, [jtok.token_bytes(t) for t in range(vocab)], jtok.eos_id),
            pc.TokenFSM(pdfa, [ptok.token_bytes(t) for t in range(vocab)], ptok.eos_id))


def _jax_dest(jtables, state, vocab):
    return np.array([jtables.advance(state, t) for t in range(vocab)], np.int32)


@pytest.mark.parametrize("name,vocab,sampled", [
    ("toolprompt", 512, 0), ("json_object", 512, 400), ("toolprompt", 128_256, 4)])
def test_native_rows_equal_the_numpy_walk_and_jax(name, vocab, sampled):
    jfsm, pfsm = _fsms(name, vocab)
    assert pfsm._native is not None and jfsm._native is not None
    tables, S = pfsm._native, pfsm.dfa.num_states
    assert tables.num_states == S and tables.vocab == vocab
    rng = np.random.default_rng(0)
    states = rng.choice(S, sampled, replace=False).tolist() if sampled else range(S)
    for s in states:
        mask, dest = pfsm._walk(s)
        got_mask, got_dest = tables.mask_for_state(s), tables.dest_row(s)
        np.testing.assert_array_equal(got_mask, mask)
        np.testing.assert_array_equal(got_dest, dest)
        np.testing.assert_array_equal(got_mask, jfsm._native.mask_for_state(s))
    # JAX's destinations through its per-token advance (a ctypes call each).
    for s in rng.choice(S, 3 if vocab > 512 else 20, replace=False).tolist():
        np.testing.assert_array_equal(tables.dest_row(s), _jax_dest(jfsm._native, s, vocab))
    for s in (-1, S):
        assert not tables.mask_for_state(s).any() and (tables.dest_row(s) == -1).all()
        assert tables.advance(s, 0) == jfsm._native.advance(s, 0) == -1


def test_host_masks_and_advances_answer_from_the_native_tables():
    _, pfsm = _fsms("json_object", 512)
    states = np.random.default_rng(1).choice(pfsm.dfa.num_states, 40, replace=False)
    for s, tok in zip(states.tolist(), range(40, 80)):
        np.testing.assert_array_equal(pfsm.mask_for_state(s), pfsm._walk(s)[0])
        assert pfsm.advance(s, tok) == pfsm.dfa.run(s, pfsm.token_bytes[tok])
    assert not pfsm._mask_cache   # the numpy walk never ran for them


@pytest.mark.parametrize("budget", [None, 1_000_000])
def test_budget_gate_matches_jax(monkeypatch, budget):
    if budget is not None:
        monkeypatch.setattr(pc, "NATIVE_TABLE_BUDGET", budget)
        monkeypatch.setattr(jc, "NATIVE_TABLE_BUDGET", budget)
    for name in SCHEMAS:
        jfsm, pfsm = _fsms(name, 512)
        within = pfsm.dfa.num_states * 512 <= pc.NATIVE_TABLE_BUDGET
        assert (pfsm._native is not None) == (jfsm._native is not None) == within, name
    assert pc.NATIVE_TABLE_BUDGET == jc.NATIVE_TABLE_BUDGET


def test_failed_build_raises_and_no_switch_turns_it_off(monkeypatch, tmp_path):
    monkeypatch.setenv("OPSAGENT_NATIVE", "0")
    assert jnative.get_lib() is None              # the JAX package's switch
    _, pfsm = _fsms("toolprompt", 512)
    assert pfsm._native is not None               # the port has none
    assert native.library_path().parent == cuda_build.BUILD_DIR
    assert native.library_path().name.startswith("libfsm_matcher_")
    broken = tmp_path / "fsm_matcher.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ fsm_matcher.cc failed"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="failed"):
        _fsms("toolprompt", 512)
    assert not list((tmp_path / "kernels").glob("*.so"))
