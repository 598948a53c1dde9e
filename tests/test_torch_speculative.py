"""The port's prompt-lookup speculative decoding against the JAX package's,
on the CPU.

``ngram_draft`` against JAX's over planted matches, no match and the
window's edges; ``Llama.verify_step``'s logits and cache against JAX's
``verify_step`` (dense f32 and tiny-mla's latent cache); the slot
indices of a verify chunk that runs past the page table against JAX's;
the speculative step body (``speculative_block``) against
``speculative_block_carry``; then the engine cases of
``tests/test_speculative.py``, each held to the JAX engine's tokens on the
same weights (tiny-test f32): greedy speculation equal to no speculation
at k = 2 and 4, under the pipelined and the synchronous block, a
repetitive continuation accepting drafts, EOS and budget, a sampled row
falling back, streaming with the prefix cache, booking drift; and the
snapshot manifest's ``speculative_k`` / ``speculative_ngram`` both ways.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu.ops.attention import _flat_slot_indices
from opsagent_tpu.serving.decode_loop import ngram_draft as jax_ngram_draft
from opsagent_tpu.serving.decode_loop import speculative_block_carry
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.snapshot import restore as jrestore
from opsagent_tpu_torch.models import config as tconfig
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.ops.attention import flat_slot_indices
from opsagent_tpu_torch.serving.decode_loop import (
    DecodeState,
    SpecState,
    ngram_draft,
    speculative_block,
    speculative_step_body,
)
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.utils.perf import get_perf_stats

# (history, at, tok, k, ngram): planted matches, the last of two, none,
# a run of one token (the candidate just before the tail),
# one at position 0, one whose
# draft would run past the written history, the full window.
DRAFTS = {
    "planted": ([5, 6, 1, 2, 9, 9, 7, 1], 8, 2, 3, 2),
    "last_of_two": ([1, 2, 3, 1, 2, 4, 8, 8, 1], 9, 2, 2, 2),
    "none": ([1, 2, 3, 4], 4, 9, 2, 2),
    "tail_only": ([3, 3, 3], 3, 3, 1, 2),
    "at_start": ([7, 8, 9, 9, 9, 9, 7], 7, 8, 3, 2),
    "draft_past_written": ([4, 5, 6, 4], 4, 5, 3, 2),
    "trigram": ([1, 2, 3, 4, 5, 1, 2, 3, 6, 1, 2], 11, 3, 2, 3),
    "unigram": ([2, 0, 1, 2, 5, 5], 6, 2, 4, 1),
    "full_window": ([1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5, 6, 7, 1, 2], 16, 3, 4, 2),
}
H = 16


@pytest.mark.parametrize("case", sorted(DRAFTS))
def test_ngram_draft_matches_jax(case):
    hist0, at, tok, k, g = DRAFTS[case]
    hist = np.zeros((2, H), np.int64)
    hist[0, : len(hist0)] = hist0
    hist[1, :5] = [1, 1, 1, 1, 1]
    at_a, tok_a = np.array([at, 5]), np.array([tok, 1])
    want = np.asarray(jax_ngram_draft(jnp.asarray(hist, jnp.int32), jnp.asarray(at_a),
                                      jnp.asarray(tok_a), k=k, ngram=g))
    got = ngram_draft(torch.from_numpy(hist), torch.from_numpy(at_a).int(),
                      torch.from_numpy(tok_a), k, g).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == -1).all() == (case in ("none", "draft_past_written"))


PAGE, PAGES, MAXP = 4, 24, 5


def _weights(jcfg, tcfg, seed=0):
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    model = Llama(tcfg, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return params, model


def _filled(jcfg, model, seed=1):
    """The same random pages in a JAX cache dict and a port cache (pages 0
    and N - 1 empty, as a fresh cache holds them)."""
    cache = model.make_cache(PAGES, PAGE)
    rng = np.random.default_rng(seed)
    jcache = {}
    for name, side in (("k", cache.k), ("v", cache.v)):
        rows = rng.standard_normal(tuple(side.shape)).astype(np.float32)
        rows[:, [0, -1]] = 0.0
        side.copy_(torch.from_numpy(rows))
        jcache[name] = jnp.asarray(rows)
    return jcache, cache


TABLE = np.full((3, MAXP), -1, np.int32)
TABLE[0, :3] = [1, 2, 3]
TABLE[1, :5] = [4, 5, 6, 7, 8]      # every column booked: a chunk past it
TABLE[2, :1] = [9]
START = np.array([5, 18, 2], np.int32)
VALID = np.array([4, 2, 0], np.int32)


@pytest.mark.parametrize("name", ["tiny-test", "tiny-mla"])
def test_verify_step_matches_jax(name):
    jcfg, tcfg = {"tiny-test": (jconfig.TINY_TEST, tconfig.TINY_TEST),
                  "tiny-mla": (jconfig.TINY_MLA, tconfig.TINY_MLA)}[name]
    params, model = _weights(jcfg, tcfg)
    jcache, cache = _filled(jcfg, model)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, 4), dtype=np.int32)
    want, jout = jax.jit(lambda p, c: jllama.verify_step(
        p, jcfg, jnp.asarray(tokens), jnp.asarray(START), jnp.asarray(VALID), c,
        jnp.asarray(TABLE), dtype=jnp.float32))(params, jcache)
    with torch.inference_mode():
        got = model.verify_step(torch.from_numpy(tokens).long(), torch.from_numpy(START),
                                torch.from_numpy(VALID), cache, torch.from_numpy(TABLE))
    assert got.shape == (3, 4, jcfg.vocab_size) and got.dtype == torch.float32
    want = np.asarray(want)
    for b, v in enumerate(VALID):
        np.testing.assert_allclose(got[b, :v].numpy(), want[b, :v], rtol=1e-4, atol=1e-4)
    for side, name_ in ((cache.k, "k"), (cache.v, "v")):
        if cache.latent and name_ == "v":
            continue
        np.testing.assert_allclose(side.numpy(), np.asarray(jout[name_]), rtol=1e-5, atol=1e-5)


def test_verify_chunk_past_the_table_writes_where_jax_does():
    """A chunk whose positions run past the page table's last column: both
    packages clamp the page column and keep only positions inside
    ``valid``, so the positions past the table drop with the rest past
    ``valid`` (the engine's ``valid`` never exceeds a row's booking)."""
    start = torch.tensor([18, 16, 19], dtype=torch.int32)
    for valid in ([2, 4, 1], [5, 5, 5], [0, 3, 2]):
        v = torch.tensor(valid, dtype=torch.int32)
        got = flat_slot_indices(torch.from_numpy(TABLE), start, 5, PAGE, PAGES, valid_len=v)
        want = _flat_slot_indices(jnp.asarray(TABLE), jnp.asarray(start.numpy()), 5, PAGE, 0,
                                  PAGES, jnp.asarray(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_speculative_body_matches_speculative_block_carry():
    """The step body over ``DecodeState`` + ``SpecState`` against JAX's scan:
    tokens, counts, the carry, the history and the cache equal. Row 0's
    history holds, after an earlier copy of its tail, the continuation the
    model gives from this cache (found by a first run without a match), so
    its drafts are accepted; row 1 has no match, row 2 no budget."""
    jcfg, tcfg = jconfig.TINY_TEST, tconfig.TINY_TEST
    params, model = _weights(jcfg, tcfg)
    B, K, N_STEPS, HIST = 3, 3, 4, MAXP * PAGE
    table = np.full((B, MAXP), -1, np.int32)
    table[0], table[1, :4], table[2, :2] = [1, 2, 3, 4, 5], [6, 7, 8, 9], [10, 11]
    at = np.array([12, 5, 1], np.int32)
    tok = np.array([300, 6, 9], np.int64)
    budgets = np.array([7, 3, 0], np.int32)
    alive = np.array([True, True, True])
    eos, pad = 511, 510

    def hist_of(row0):
        hist = np.zeros((B, HIST), np.int64)
        hist[0, :12] = row0
        hist[1, :5] = [1, 2, 3, 4, 5]
        hist[2, :1] = [9]
        return hist

    def run_jax(hist, eos):
        jcache = {n: jnp.zeros((jcfg.num_layers, PAGES, PAGE, jcfg.num_kv_heads,
                                jcfg.head_dim_), jnp.float32) for n in "kv"}
        return speculative_block_carry(
            params, jcfg, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32), jnp.zeros(B, bool),
            jnp.zeros((B, HIST), jnp.int32), jnp.ones(B, bool), jnp.asarray(tok, jnp.int32),
            jnp.asarray(at), jnp.asarray(hist, jnp.int32), jnp.asarray(alive),
            jnp.asarray(budgets), jcache, jnp.asarray(table), jnp.int32(eos), jnp.int32(pad),
            n_steps=N_STEPS, k=K, ngram=2, dtype=jnp.float32)

    probe_t, probe_c = map(np.asarray, run_jax(hist_of(list(range(50, 62))), eos)[:2])
    cont = [int(t) for st in range(N_STEPS) for t in probe_t[0, st, : probe_c[0, st]]]
    assert len(cont) == 4 and tok[0] not in cont
    hist = hist_of([50, int(tok[0]), *cont, 70, 71, 72, 73, 74, 50])
    eos = cont[3]                       # ends row 0 inside the block
    want_t, want_c, jcache, (jtok, jat, jeos, jhist) = run_jax(hist, eos)
    state = DecodeState.empty(B, MAXP, 8, torch.device("cpu"))
    spec = SpecState.empty(B, HIST, N_STEPS, K, torch.device("cpu"))
    cache = model.make_cache(PAGES, PAGE)
    step = partial(speculative_step_body, model, state, spec, cache, eos, pad, 2)
    with torch.inference_mode():
        got_t, got_c = speculative_block(
            state, spec, step, tok, at, alive, budgets, table, N_STEPS,
            {b: list(hist[b, : at[b]]) for b in range(B)})
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c[0].tolist()[:2] == [4, 0]      # three drafts and EOS, then done
    assert got_c[1].tolist() == [1, 1, 1, 0]    # no match: one a step, budget 3
    assert got_c[2].sum() == 0                  # budget 0
    np.testing.assert_array_equal(state.tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(state.at.numpy(), np.asarray(jat))
    np.testing.assert_array_equal(state.eos.numpy(), np.asarray(jeos))
    np.testing.assert_array_equal(spec.hist[:, :HIST].numpy(), np.asarray(jhist))
    for side, name in ((cache.k, "k"), (cache.v, "v")):
        np.testing.assert_allclose(side.numpy(), np.asarray(jcache[name]), rtol=1e-5, atol=1e-5)


# -- the engine --------------------------------------------------------------
BASE = dict(page_size=8, num_pages=512, max_pages_per_seq=32, max_batch_size=4, seed=0)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7], [4, 4, 4, 4, 4, 4]]


@pytest.fixture(scope="module")
def jax_tree():
    jeng = JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=1,
                                     prefill_buckets=(16,), **BASE))
    return jax.tree_util.tree_map(np.asarray, jeng.params)


def _jax(jax_tree, **over):
    kw = {**BASE, **over}
    return JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=1,
                                     prefill_buckets=(16,), **kw),
                     params=jax.tree_util.tree_map(jnp.asarray, jax_tree))


def _port(jax_tree, **over):
    model = Llama(tconfig.TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax_tree, tconfig.TINY_TEST))
    return Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                               **{**BASE, **over}), model=model)


def _greedy(n):
    return SamplingParams(temperature=0.0, max_tokens=n)


def _jgreedy(n):
    return JaxSamplingParams(temperature=0.0, max_tokens=n)


@pytest.mark.parametrize("depth", [2, 0])
@pytest.mark.parametrize("k", [2, 4])
def test_speculative_matches_vanilla_and_jax(jax_tree, k, depth):
    want = _jax(jax_tree, speculative_k=k).generate(PROMPTS, _jgreedy(24))
    assert _port(jax_tree).generate(PROMPTS, _greedy(24)) == want
    eng = _port(jax_tree, speculative_k=k, pipeline_depth=depth)
    assert eng.generate(PROMPTS, _greedy(24)) == want
    assert eng.spec_blocks > 0 and eng.spec_eager_steps > 0
    assert eng.decode_eager_steps == 0


def test_speculative_accepts_repetitive_continuations(jax_tree):
    """A continuation that loops: some iteration emits several tokens, so
    the verify forwards number fewer than the tokens."""
    prompt = [[1, 2, 3, 4, 1, 2, 3, 4]]
    want = _jax(jax_tree, speculative_k=4).generate(prompt, _jgreedy(48))
    perf = get_perf_stats()
    perf.reset()
    eng = _port(jax_tree, speculative_k=4)
    assert eng.generate(prompt, _greedy(48)) == want
    steps = perf.get_stats()["engine.spec_step_tokens"]
    assert steps["count"] < 48 and steps["max"] > 1
    assert eng.spec_eager_steps < 48


def test_speculative_respects_eos_and_budget(jax_tree):
    want = _jax(jax_tree).generate([[1, 2, 3]], _jgreedy(5))
    eng = _port(jax_tree, speculative_k=3)
    assert eng.generate([[1, 2, 3]], _greedy(5)) == want
    assert len(want[0]) <= 5
    # The EOS id set to a token of the greedy stream ends it there.
    ref = _port(jax_tree).generate([[5, 1, 5, 1, 5]], _greedy(20))[0]
    eng = _port(jax_tree, speculative_k=3)
    eng.tokenizer.eos_id = ref[6]
    got = eng.generate([[5, 1, 5, 1, 5]], _greedy(20))[0]
    assert got == ref[: ref.index(ref[6]) + 1]


def test_speculative_with_sampled_rows_falls_back(jax_tree):
    """A block with a temperature > 0 row decodes without speculation (it
    is exact for greedy rows only), and still completes."""
    eng = _port(jax_tree, speculative_k=4)
    a = eng.add_request([1, 2, 3], _greedy(6))
    b = eng.add_request([4, 5, 6], SamplingParams(temperature=0.8, max_tokens=6))
    pending = {a, b}
    while pending:
        eng.step_block(sorted(pending))
        pending = {i for i in pending if not eng.sequences[i].done}
    assert len(eng.finish(a)) == 6 and len(eng.finish(b)) == 6
    assert eng.spec_blocks == 0 and eng.decode_eager_steps > 0


def test_speculative_streaming_and_prefix_cache(jax_tree):
    prompt = [7, 6, 5, 4, 3, 2] * 3            # two full pages to cache
    want = _jax(jax_tree).generate([prompt], _jgreedy(12))[0]
    eng = _port(jax_tree, speculative_k=3)
    seen: list[int] = []
    sid = eng.add_request(prompt, _greedy(12), stream=seen.append)
    while not eng.sequences[sid].done:
        eng.step_block([sid])
    assert eng.finish(sid) == want and seen == want
    assert eng.generate([prompt], _greedy(12))[0] == want
    assert eng.alloc.hit_tokens > 0


def test_speculative_booking_drift_does_not_truncate(jax_tree):
    """Unspent speculative bookings are rolled back on the pull: with a
    tight per-sequence page cap, drift would otherwise reach
    max_pages_per_seq and cut the reply short."""
    prompt, n = [[3, 1, 4, 1, 5, 9, 2, 6]], 64
    want = _jax(jax_tree, max_pages_per_seq=12, speculative_k=3).generate(prompt, _jgreedy(n))
    eng = _port(jax_tree, max_pages_per_seq=12, speculative_k=3)
    got = eng.generate(prompt, _greedy(n))
    assert got == want == _port(jax_tree, max_pages_per_seq=12).generate(prompt, _greedy(n))
    assert len(got[0]) == n or got[0][-1] == eng.tokenizer.eos_id
    assert eng.alloc.accounting()["owned"] == 0


def test_warmup_prepares_the_speculative_step(jax_tree):
    """Warmup runs the speculative body over idle rows: the cache's pages
    and the tokens after it are unchanged."""
    eng = _port(jax_tree, speculative_k=2)
    sid = eng.add_request(PROMPTS[0], _greedy(10))
    before = [t.clone() for t in (eng.cache.k, eng.cache.v)]
    eng.warmup()
    assert all(torch.equal(a, b) for a, b in zip(before, (eng.cache.k, eng.cache.v)))
    assert eng.spec_eager_steps == 0
    while not eng.sequences[sid].done:
        eng.step_block()
    assert eng.finish(sid) == _port(jax_tree).generate(PROMPTS[:1], _greedy(10))[0]


def test_speculative_settings_cross_the_snapshot_both_ways(tmp_path, jax_tree):
    """The manifest's ``speculative_k`` / ``speculative_ngram`` come from
    the engine (they were constants) and read back in both packages."""
    eng = _port(jax_tree, speculative_k=3, speculative_ngram=3)
    man = eng.snapshot(str(tmp_path / "snap"))
    assert (man["engine"]["speculative_k"], man["engine"]["speculative_ngram"]) == (3, 3)
    cfg = jrestore.engine_config_from_manifest(man)
    assert (cfg.speculative_k, cfg.speculative_ngram) == (3, 3)
    restored = Engine.from_snapshot(str(tmp_path / "snap"), device="cpu")
    assert (restored.cfg.speculative_k, restored.cfg.speculative_ngram) == (3, 3)
    jeng = _jax(jax_tree, speculative_k=2, speculative_ngram=1)
    jeng.snapshot(str(tmp_path / "jsnap"))
    restored = Engine.from_snapshot(str(tmp_path / "jsnap"), device="cpu")
    assert (restored.cfg.speculative_k, restored.cfg.speculative_ngram) == (2, 1)
    assert restored.generate(PROMPTS, _greedy(8)) == jeng.generate(PROMPTS, _jgreedy(8))
    assert restored.spec_blocks > 0


def test_cli_speculative_k(tmp_path):
    """``--speculative-k`` reaches the engine of ``snapshot create`` (and of
    ``serve-engine``, which builds its engine the same way); JAX's
    defaults: k 0, n-gram 2."""
    from opsagent_tpu_torch import __main__ as cli
    from opsagent_tpu_torch.serving.snapshot.manifest import read_manifest

    assert dataclasses.asdict(EngineConfig())["speculative_k"] == 0
    assert EngineConfig().speculative_ngram == 2
    path = str(tmp_path / "cli-snap")
    assert cli.main(["snapshot", "create", "--out", path, "--device", "cpu",
                     "--model-name", "tiny-test", "--speculative-k", "3"]) == 0
    assert read_manifest(path)["engine"]["speculative_k"] == 3
