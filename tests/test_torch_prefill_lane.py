"""The split prefill lane (``EngineConfig(mixed_batching=False)``) against the
JAX package's, on the CPU.

Same weights (the JAX package's ``init_params`` carried across with
``params_from_jax``) and the same inputs, made from a numpy seed:

- ``ops.attention.paged_prefix_attention`` against JAX's: each row's tail
  over its cached prefix pages plus the tail, a zero-length row, the
  layer-axis form; f32 to 1e-5, bf16 to 2**-6, int8 pages to 1e-5 (the same
  codes and scales on both sides), and the MLA latent shape (one kv head of
  576 columns read as k and v) to 1e-5. JAX's padding rows hold finite
  garbage, the port's zeros: valid rows are compared.
- ``Llama.prefill`` and ``prefill_with_prefix`` against JAX's at tiny-test
  (f32; int8 KV pages; bf16) and tiny-mla (latent cache and materialized):
  the last valid position's logits (f32 1e-4, the two-layer stack summing
  in other orders; bf16 0.05 and the same argmax where JAX's margin is
  clear) and the caches they write (f32 1e-4, int8 codes within one step).
- ``Engine.prefill_batch`` / ``prefill_step`` against the JAX engine with
  ``mixed_batching=False``: per-chunk results, first tokens, every cache
  byte, pages; a raising ``mask_fn`` and a raising stream callback fail
  their own row only, a failed dispatch drops every row.
- ``Scheduler._advance_prefill``: the same chunk batches as the JAX
  scheduler (the oldest admitting request plus those whose next chunk pads
  to its bucket), and greedy replies through ``ServingStack`` equal to the
  JAX stack's and to the port's mixed ticks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu.ops import attention as jattn
from opsagent_tpu.serving.api import ServingStack as JaxStack
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.scheduler import Request as JaxRequest
from opsagent_tpu.serving.scheduler import Scheduler as JaxScheduler
from opsagent_tpu_torch import obs as pobs
from opsagent_tpu_torch.models import config as tconfig
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.ops import attention as tattn
from opsagent_tpu_torch.serving.api import ServingStack
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.serving.scheduler import Request, Scheduler

ATTN_TOL = {"f32": 1e-5, "bf16": 2 ** -6, "int8": 1e-5}
STEP_TOL = 1e-4
BF16_LOGIT_TOL = 5e-2
PAGE, PAGES, MAXP = 4, 32, 8
SHAPE = dict(page_size=4, num_pages=64, max_pages_per_seq=16, max_batch_size=4,
             decode_block=4, seed=0)
BUCKETS = (8, 16, 32)
# Prompt lengths: one chunk at bucket 8, one at 16, and two chunks (32, 8).
PROMPTS = [[257] + list(range(40, 44)), [257] + list(range(60, 73)),
           [257] + [(7 * i) % 250 + 1 for i in range(39)]]
MAX_TOKENS = 6


@pytest.fixture(autouse=True)
def reset_port_obs():
    pobs.get_registry().reset()
    pobs.flight.get_recorder().reset()
    yield
    pobs.get_registry().reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- paged_prefix_attention ------------------------------------------------------
def _attention_case(rng, H=4, K=2, D=16, layers=None):
    B, S = 3, 16
    start = np.array([0, 5, 9], np.int32)
    lengths = np.array([16, 7, 0], np.int32)
    table = np.full((B, MAXP), -1, np.int32)
    table[0, :4] = [7, 2, 9, 11]
    table[1, :3] = [4, 0, 13]
    table[2, :3] = [5, 6, 8]
    lead = (PAGES,) if layers is None else (layers, PAGES)
    k = rng.standard_normal((*lead, PAGE, K, D)).astype(np.float32)
    v = rng.standard_normal((*lead, PAGE, K, D)).astype(np.float32)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, table, start, lengths


def _valid(out, lengths):
    out = np.asarray(out, np.float32)
    return np.concatenate([out[b, :n] for b, n in enumerate(lengths)])


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_paged_prefix_attention_matches_jax(mode, layered):
    rng = np.random.default_rng(0)
    q, k, v, table, start, lengths = _attention_case(rng, layers=3 if layered else None)
    layer = 1 if layered else None
    if mode == "int8":
        codes = [rng.integers(-127, 128, a.shape).astype(np.int8) for a in (k, v)]
        scales = [rng.uniform(0.005, 0.02, a.shape[:-1]).astype(np.float32) for a in (k, v)]
        jk, jv = (jattn.QuantizedPages(jnp.asarray(c), jnp.asarray(s))
                  for c, s in zip(codes, scales))
        tk, tv = (tattn.QuantizedPages(_t(c), _t(s)) for c, s in zip(codes, scales))
        jq, tq = jnp.asarray(q), _t(q)
    elif mode == "bf16":
        jk, jv, jq = (jnp.asarray(a, jnp.bfloat16) for a in (k, v, q))
        tk, tv, tq = (_t(a).to(torch.bfloat16) for a in (k, v, q))
    else:
        jk, jv, jq = map(jnp.asarray, (k, v, q))
        tk, tv, tq = map(_t, (k, v, q))
    want = jattn.paged_prefix_attention(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(start), jnp.asarray(lengths),
        layer=None if layer is None else jnp.int32(layer))
    got = tattn.paged_prefix_attention(tq, tk, tv, _t(table), _t(start), _t(lengths),
                                       layer=layer)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = ATTN_TOL[mode]
    np.testing.assert_allclose(_valid(got.float(), lengths),
                               _valid(jnp.asarray(want, jnp.float32), lengths),
                               rtol=tol, atol=tol)
    # A row with no tail, and the padding past each tail, come out as zeros.
    assert not got[2].any() and not got[1, 7:].any()


def test_latent_prefix_attention_matches_jax():
    """The MLA latent shape: one kv head of 576 columns, the same pages read
    as keys and values (the dma kernels' latent instance on the card)."""
    rng = np.random.default_rng(1)
    q, k, _, table, start, lengths = _attention_case(rng, H=4, K=1, D=576)
    q, k = q * 0.05, k * 0.05
    want = jattn.paged_prefix_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                        jnp.asarray(table), jnp.asarray(start),
                                        jnp.asarray(lengths))
    pages = _t(k)
    got = tattn.paged_prefix_attention(_t(q), pages, pages, _t(table), _t(start),
                                       _t(lengths), backend="dma")
    np.testing.assert_allclose(_valid(got, lengths), _valid(want, lengths),
                               rtol=ATTN_TOL["f32"], atol=ATTN_TOL["f32"])


def test_prefix_attention_is_the_ragged_contract():
    """``paged_prefix_attention`` on the CPU is ``paged_ragged_attention`` with
    ``q_lens = lengths``, bit for bit, whatever the backend named."""
    rng = np.random.default_rng(2)
    q, k, v, table, start, lengths = map(_t, _attention_case(rng))
    want = tattn.paged_ragged_attention(q, k, v, table, start, lengths)
    for backend in ("dma", "grid"):
        got = tattn.paged_prefix_attention(q, k, v, table, start, lengths, backend=backend)
        assert torch.equal(got, want)


# -- Llama.prefill and prefill_with_prefix ---------------------------------------------
def _pair(name, latent=True):
    if name == "tiny-test":
        return jconfig.TINY_TEST, tconfig.TINY_TEST
    import dataclasses

    return tuple(dataclasses.replace(c.TINY_MLA, mla=dataclasses.replace(
        c.TINY_MLA.mla, latent_cache=latent)) for c in (jconfig, tconfig))


def _models(jcfg, tcfg, dtype):
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jdtype)
    model = Llama(tcfg, dtype, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params), tcfg))
    return params, model, jdtype


def _prefill_both(name, latent, dtype, kv_quantize=""):
    """Fresh prompts through ``prefill``, then their tails through
    ``prefill_with_prefix`` (a zero-length row and a row left out), through
    both packages: [(port logits, JAX logits)] of the valid rows and the
    final caches as [(port, JAX)] arrays."""
    jcfg, tcfg = _pair(name, latent)
    params, model, jdtype = _models(jcfg, tcfg, dtype)
    rng = np.random.default_rng(3)
    B = 3
    table = np.full((B, MAXP), -1, np.int32)
    table[0, :5] = [7, 2, 9, 11, 1]
    table[1, :5] = [4, 0, 13, 5, 3]
    table[2, :5] = [14, 15, 16, 17, 18]
    jcache = jllama.make_cache(jcfg, PAGES, PAGE, dtype=jdtype, kv_quantize=kv_quantize)
    tcache = model.make_cache(PAGES, PAGE, kv_quantize)
    pairs = []
    tokens = rng.integers(0, 500, (B, 12)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)
    want, jcache = jllama.prefill(params, jcfg, jnp.asarray(tokens), jnp.asarray(lengths),
                                  jcache, jnp.asarray(table), dtype=jdtype)
    got = model.prefill(_t(tokens).long(), _t(lengths), tcache, _t(table))
    pairs.append((got.numpy(), np.asarray(want, np.float32)))
    tail = rng.integers(0, 500, (B, 8)).astype(np.int32)
    start, tlens = np.array([12, 7, 9], np.int32), np.array([8, 0, 5], np.int32)
    want, jcache = jllama.prefill_with_prefix(
        params, jcfg, jnp.asarray(tail), jnp.asarray(start), jnp.asarray(tlens), jcache,
        jnp.asarray(table), dtype=jdtype)
    got = model.prefill_with_prefix(_t(tail).long(), _t(start), _t(tlens), tcache, _t(table))
    ok = tlens > 0
    pairs.append((got.numpy()[ok], np.asarray(want, np.float32)[ok]))

    def planes(side, jside):
        if kv_quantize:
            return [(side.q.numpy().astype(np.float32), np.asarray(jside.q, np.float32)),
                    (side.scale.numpy(), np.asarray(jside.scale))]
        return [(side.float().numpy(), np.asarray(jside.astype(jnp.float32)))]

    caches = planes(tcache.k, jcache["k"]) + planes(tcache.v, jcache["v"])
    return pairs, caches


@pytest.mark.parametrize("name,latent,kv", [("tiny-test", True, ""), ("tiny-test", True, "int8"),
                                            ("tiny-mla", True, ""), ("tiny-mla", False, "")])
def test_prefill_and_prefill_with_prefix_match_jax(name, latent, kv):
    pairs, caches = _prefill_both(name, latent, torch.float32, kv)
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for i, (got, want) in enumerate(caches):
        assert got.shape == want.shape
        # int8 codes: a row's absmax rounding may move a code by one step.
        tol = 1.0 if kv and i % 2 == 0 else STEP_TOL
        np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=tol)


def test_prefill_matches_jax_in_bf16():
    """bf16 weights and activations on both sides: logits within 0.05 (two
    layers of bf16 rounding summed in other orders; JAX also rounds the
    attention probabilities to bf16), caches within one bf16 rounding."""
    pairs, caches = _prefill_both("tiny-test", True, torch.bfloat16)
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=BF16_LOGIT_TOL, atol=BF16_LOGIT_TOL)
    for got, want in caches:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -5)


def test_prefill_raises_on_the_card_path_without_plain(monkeypatch):
    """``Llama.prefill`` attends in plain PyTorch: a CUDA tensor must ask for
    that reference by name (the engine prefills through
    ``prefill_with_prefix``)."""
    model = Llama(tconfig.TINY_TEST, torch.float32, "cpu", seed=0)
    cache = model.make_cache(PAGES, PAGE)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="prefill_with_prefix"):
        model.prefill(tokens, torch.tensor([4], dtype=torch.int32), cache,
                      torch.full((1, MAXP), -1, dtype=torch.int32))


# -- Engine.prefill_batch / prefill_step --------------------------------------------
@functools.lru_cache(maxsize=None)
def _weights():
    jeng = _jax_engine()
    model = Llama(tconfig.TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params),
                                          tconfig.TINY_TEST))
    return model


def _jax_engine(**over):
    return JaxEngine(JaxEngineConfig(
        model="tiny-test", dtype=jnp.float32, tp=1, pipeline_depth=0, mixed_batching=False,
        prefill_buckets=BUCKETS, prefill_batch=4, **{**SHAPE, **over}))


def _port_engine(**over):
    return Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                               mixed_batching=False, prefill_buckets=BUCKETS,
                               prefill_batch=4, **{**SHAPE, **over}), model=_weights())


def _caches(eng):
    if isinstance(eng, Engine):
        return [eng.cache.k.numpy(), eng.cache.v.numpy()]
    return [np.asarray(eng.cache["k"]), np.asarray(eng.cache["v"])]


def _batches(eng, sp):
    """Admit the three prompts, then chunk batches until every prompt is
    done: [(batch, results as bool or exception type name, first tokens)]."""
    sids = [eng.begin_request(p, sp) for p in PROMPTS]
    log = []
    pending = list(sids)
    while pending:
        bucket = eng.next_prefill_bucket(pending[0])
        batch = [pending[0]] + [s for s in pending[1:]
                                if eng.next_prefill_bucket(s) == bucket]
        out = eng.prefill_batch(batch)
        log.append((bucket, [sids.index(s) for s in batch],
                    [v if isinstance(v, bool) else type(v).__name__ for v in out.values()],
                    [eng.sequences[s].tokens[:] if s in eng.sequences else None
                     for s in batch]))
        pending = [s for s in pending if s in eng._prefilling]
    return sids, log


def test_prefill_batch_matches_jax_engine():
    jeng, eng = _jax_engine(), _port_engine()
    _, jlog = _batches(jeng, JaxSamplingParams(max_tokens=MAX_TOKENS))
    sids, log = _batches(eng, SamplingParams(max_tokens=MAX_TOKENS))
    assert log == jlog
    # Bucket 32 groups none (the two-chunk prompt alone), bucket 8 groups
    # the short prompt with the long one's tail.
    assert [entry[:2] for entry in log] == [(8, [0]), (16, [1]), (32, [2]), (8, [2])]
    for got, want in zip(_caches(eng), _caches(jeng)):
        np.testing.assert_allclose(got[:, :SHAPE["num_pages"]], want, rtol=STEP_TOL,
                                   atol=STEP_TOL)
    # The rest of the turn decodes in blocks to the JAX engine's tokens.
    assert [eng.generate([p], SamplingParams(max_tokens=MAX_TOKENS))[0] for p in PROMPTS] == \
        [jeng.generate([p], JaxSamplingParams(max_tokens=MAX_TOKENS))[0] for p in PROMPTS]
    assert eng.prefill_dispatches > 0 and eng.mixed_eager_ticks == 0


def test_add_request_and_prefill_step_without_mixed_batching():
    """``add_request`` runs the split lane's chunks when mixed batching is
    off (JAX's ``prefill_step`` loop), a fresh prompt's first chunk included."""
    want = _jax_engine().generate(PROMPTS, JaxSamplingParams(max_tokens=MAX_TOKENS))
    eng = _port_engine()
    assert eng.generate(PROMPTS, SamplingParams(max_tokens=MAX_TOKENS)) == want
    assert eng.mixed_eager_ticks == 0 and eng.prefill_dispatches == 4
    sid = eng.begin_request([257] + list(range(100, 139)), SamplingParams(max_tokens=2))
    assert eng.prefill_step(sid) is False and eng.prefill_step(sid) is True
    assert len(eng.sequences[sid].tokens) == 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_row_local_failures_and_a_failed_dispatch(side, monkeypatch):
    """A ``mask_fn`` that raises on the first token and a stream callback
    that raises on it fail their own rows (Exception results, sequences
    dropped, pages freed); the third row completes. A failed dispatch drops
    every row and re-raises."""
    eng = _jax_engine() if side == "jax" else _port_engine()
    sp = (JaxSamplingParams if side == "jax" else SamplingParams)(max_tokens=MAX_TOKENS)
    free0 = eng.alloc.accounting()["free"]
    # The port's admission calls mask_fn([]) once to validate it; the JAX
    # engine's does not. The mask raises from its next call on: the first
    # token's.
    calls = {"n": 0, "ok": 1 if side == "port" else 0}

    def mask(tokens):
        calls["n"] += 1
        if calls["n"] > calls["ok"]:
            raise RuntimeError("mask exploded on the first token")
        return np.ones((eng.model_cfg.vocab_size,), bool)

    def stream(token):
        raise RuntimeError("stream exploded")

    p = [257, 5, 6, 7]
    a = eng.begin_request(p, sp, mask_fn=mask)
    b = eng.begin_request(p[:3] + [9], sp, stream=stream)
    c = eng.begin_request(p[:2] + [8, 8], sp)
    out = eng.prefill_batch([a, b, c])
    assert [type(out[s]).__name__ for s in (a, b)] == ["RuntimeError", "RuntimeError"]
    assert out[c] is True
    assert a not in eng.sequences and b not in eng.sequences and c in eng.sequences
    eng.finish(c)
    assert eng.alloc.accounting()["owned"] == 0
    d = eng.begin_request([257, 1, 2], sp)
    e = eng.begin_request([257, 3, 4], sp)
    boom = RuntimeError("dispatch exploded")

    def fail(*a, **k):
        raise boom

    if side == "jax":
        eng._prefill_prefix_jit = fail
    else:
        # The model is shared with the other tests: patched for this one.
        monkeypatch.setattr(eng.model, "prefill_with_prefix", fail)
    with pytest.raises(RuntimeError, match="dispatch exploded"):
        eng.prefill_batch([d, e])
    assert d not in eng.sequences and e not in eng.sequences and not eng._prefilling
    acct = eng.alloc.accounting()
    assert acct["owned"] == 0 and acct["free"] + acct["trie"] == acct["total"]
    assert free0 == acct["total"]


# -- the scheduler ---------------------------------------------------------------------
SIDES = {
    "jax": (_jax_engine, JaxScheduler, JaxRequest, JaxSamplingParams),
    "port": (_port_engine, Scheduler, Request, SamplingParams),
}


def _grouping(side):
    """Five admitting requests through ``_try_admit`` and ``_advance_prefill``
    by hand: the batches each tick dispatched (indices into the arrival
    order) until every prompt is done."""
    make, sched_cls, req_cls, sp_cls = SIDES[side]
    eng = make(max_batch_size=8, num_pages=128)
    sched = sched_cls(eng)
    batches = []
    inner = eng.prefill_batch

    def spy(seq_ids):
        batches.append(sorted(order[s] for s in seq_ids))
        return inner(seq_ids)

    eng.prefill_batch = spy
    prompts = [PROMPTS[0], PROMPTS[2], PROMPTS[1], PROMPTS[0][:3] + [99], PROMPTS[2][:30]]
    reqs = [req_cls(prompt_ids=p, sampling=sp_cls(max_tokens=2)) for p in prompts]
    for r in reqs:
        sched._waiting.append(r)
    sched._try_admit()
    order = {r.seq_id: i for i, r in enumerate(reqs)}
    for _ in range(10):
        if not sched._prefilling:
            break
        sched._advance_prefill()
    firsts = [eng.sequences[r.seq_id].tokens[:1] for r in reqs]
    return batches, firsts


def test_advance_prefill_groups_as_the_jax_scheduler():
    jax_batches, jax_first = _grouping("jax")
    batches, first = _grouping("port")
    assert batches == jax_batches and first == jax_first
    # The oldest first, with the same-bucket chunks of the others.
    assert batches[0] == [0, 3]


def test_split_lane_replies_equal_jax_and_the_mixed_ticks():
    bodies = [{"messages": [{"role": "user", "content": "status of pod %d" % i + " now" * i}],
               "max_tokens": MAX_TOKENS, "temperature": 0} for i in range(4)]
    replies = {}
    for name, stack in (("jax", JaxStack(_jax_engine())), ("split", ServingStack(_port_engine())),
                        ("mixed", ServingStack(Engine(EngineConfig(
                            model="tiny-test", dtype=torch.float32, device="cpu",
                            **SHAPE), model=_weights())))):
        try:
            replies[name] = [stack.chat_completion(dict(b))["choices"][0]["message"]["content"]
                             for b in bodies]
        finally:
            stack.close()
    assert replies["split"] == replies["jax"] == replies["mixed"]
