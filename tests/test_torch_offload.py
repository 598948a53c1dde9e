"""The port's host KV tier (``serving/offload``), allocator hooks, parking
and the KV page wire format (``serving/fleet/transfer.py``), against the
JAX package on the CPU. Bit-exact unless a test says otherwise.

- ``chain_key_hex``, ``HostPagePool`` (put, match, LRU drops, coverage,
  ``stats``, ``clear``) and the allocator's spill hook, ``promote_prefix`` and
  ``evict_chain`` give the JAX package's results for one script each.
- Park and restore round-trip every page byte at f32, bf16 and int8 KV and
  at the ``tiny-mla`` latent layout; a copy engine bucket pads with the
  first page id and the duplicated lanes leave the cache as it was.
- A session parked mid-conversation by the scheduler's pressure parking
  gives the greedy tokens of a never-parked run and of the JAX engine
  (f32 and int8 KV), with no ``restore_reprefill`` anomaly.
- Records cross the packages both ways: a JAX engine's parked pages
  (tiny-test, f32 and int8 KV) restore in the port, whose continuation
  gives the JAX engine's greedy tokens; the port's records, bf16 ones
  included, unpack in the JAX package to the same leaf bytes.
- A corrupted digest, a truncated record and a malformed leaf are
  rejected, counted and anomaly-dumped; a parked session whose host pages
  were dropped re-prefills with the ``restore_reprefill`` anomaly.
- Tool-time parking through ``park_session("cuda://...")``, and the four
  ``/fleet/*`` routes between two port servers: a session exported from one
  and imported into the other restores there with the same greedy text;
  ``/healthz`` shows ``host_pool`` and ``init``.
"""

import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.fleet import transfer as jtransfer
from opsagent_tpu.serving.kvcache import PageAllocator as JaxAllocator
from opsagent_tpu.serving.offload import pool as jpool
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu_torch import obs as pobs
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import DTYPE_NAMES, leaf_bytes, params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving import api as papi
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.fleet import transfer as ptransfer
from opsagent_tpu_torch.serving.kvcache import PageAllocator
from opsagent_tpu_torch.serving.offload import PageCopyEngine
from opsagent_tpu_torch.serving.offload import pool as ppool
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.serving.scheduler import Request, Scheduler

BASE = dict(page_size=4, num_pages=64, max_pages_per_seq=16, max_batch_size=4,
            decode_block=4, mixed_buckets=(4, 8, 16), max_step_tokens=32)
JBASE = dict(model="tiny-test", dtype=jnp.float32, tp=1, page_size=4, num_pages=64,
             max_pages_per_seq=16, max_batch_size=4, prefill_buckets=(16, 32),
             decode_block=4, seed=0)


@pytest.fixture(autouse=True)
def reset_port_obs():
    pobs.get_registry().reset()
    pobs.flight.get_recorder().reset()
    yield
    pobs.get_registry().reset()
    pobs.flight.get_recorder().reset()


@functools.lru_cache(maxsize=None)
def _jax_engine(kvq: str = "") -> JaxEngine:
    return JaxEngine(JaxEngineConfig(offload=True, kv_quantize=kvq, **JBASE))


@functools.lru_cache(maxsize=None)
def _model(dtype=torch.float32) -> Llama:
    """tiny-test with the JAX engine's weights."""
    model = Llama(TINY_TEST, dtype, "cpu", seed=None)
    params = jax.tree_util.tree_map(np.asarray, _jax_engine().params)
    model.load_state_dict(params_from_jax(params, TINY_TEST))
    return model


def _engine(model=None, **over) -> Engine:
    model = model or _model()
    kw = {**BASE, "offload": True, **over}
    return Engine(EngineConfig(model=model.cfg.name, dtype=model.dtype, device="cpu",
                               **kw), model=model)


def _finish_all(eng, sids):
    pending = [s for s in sids if not eng.sequences[s].done]
    while pending:
        eng.step_block(pending)
        pending = [s for s in pending if not eng.sequences[s].done]
    eng.drain()
    return [eng.finish(s) for s in sids]


def _run(eng, prompt, max_tokens):
    sid = eng.begin_request(list(prompt), SamplingParams(max_tokens=max_tokens))
    while sid in eng._prefilling:
        eng.step_mixed([], {sid: eng.cfg.mixed_buckets[-1]})
    return _finish_all(eng, [sid])[0]


def _pages(eng, pages):
    return {name: leaf[:, pages].clone() for name, leaf in eng.cache.page_leaves().items()}


# -- digests and the host pool -------------------------------------------------
def test_chain_key_hex_equals_jax():
    rng = np.random.default_rng(0)
    for n in (1, 4, 16, 257, 3000):
        toks = rng.integers(0, 2**31 - 1, n).tolist()
        assert ppool.chain_key_hex(toks) == jpool.chain_key_hex(toks)


def _trees(value: float):
    a = np.full((2, 4, 1, 8), value, np.float32)
    return {"k": a, "v": a + 1}, {"k": torch.from_numpy(a), "v": torch.from_numpy(a + 1)}


def test_host_pool_script_equals_jax():
    one = 2 * 2 * 4 * 8 * 4
    jp, pp = jpool.HostPagePool(4, capacity_bytes=5 * one), ppool.HostPagePool(4, capacity_bytes=5 * one)
    a, b = list(range(100, 116)), list(range(100, 108)) + list(range(200, 212))
    results = []
    for pool, side in ((jp, 0), (pp, 1)):
        out = []
        for i in range(4):
            out.append(pool.put(a[: (i + 1) * 4], _trees(float(i))[side]))
        out.append(pool.put(a[:3], _trees(9.0)[side]))            # unaligned
        out.append(pool.put(a[:4], _trees(7.0)[side]))            # refresh
        out.append([len(pool.match(a)), len(pool.match(a, start_page=1, max_pages=2))])
        for i in range(2, 5):                                     # a 2nd chain: drops
            out.append(pool.put(b[: (i + 1) * 4], _trees(10.0 + i)[side]))
        out.append([pool.coverage(a), pool.coverage(b, start_page=2), len(pool.match(b))])
        out.append([float(np.asarray(e.data["k"])[0, 0, 0, 0]) for e in pool.match(a)])
        out.append(sorted(pool.digests()))
        out.append(pool.stats())
        results.append(out)
    assert results[0] == results[1]
    assert results[1][-1]["drops"] > 0


def test_allocator_script_equals_jax():
    """Spill-hook calls, promote_prefix, evict_chain and accounting for one
    script (the JAX package's tests/test_offload.py allocator cases)."""
    outs = []
    for cls, pool_cls in ((JaxAllocator, jpool.HostPagePool), (PageAllocator, ppool.HostPagePool)):
        alloc = cls(num_pages=8, page_size=4, max_pages_per_seq=8)
        alloc.attach_host_pool(pool_cls(4, capacity_bytes=1 << 20))
        spilled = []
        alloc.set_spill(lambda page, chain: spilled.append((page, list(chain))))
        toks = list(range(1, 25))
        sid = alloc.allocate(len(toks))
        alloc.free(sid, tokens=toks)
        sid2 = alloc.allocate(24)                    # evicts trie leaves
        out = [list(spilled), alloc.accounting(), sorted(map(tuple, alloc.trie_chains()))]
        alloc.free(sid2)
        t2 = list(range(50, 66))
        sid3 = alloc.allocate(len(t2))
        out.append(alloc.promote_prefix(sid3, t2[:12]))
        hit = alloc.match_prefix(t2[:12])
        sid4 = alloc.allocate(13, prefix_pages=hit)
        out += [hit, alloc.pages_of(sid4), alloc.accounting(), alloc.can_admit(20)]
        alloc.free(sid3, tokens=t2)
        alloc.free(sid4)
        chain = alloc.match_prefix(t2)
        pin = alloc.allocate(9, prefix_pages=chain[:2])
        out.append(alloc.evict_chain(chain))
        alloc.free(pin)
        out.append(alloc.evict_chain(alloc.match_prefix(t2)))
        alloc.set_spill(lambda *_: (_ for _ in ()).throw(RuntimeError("boom")))
        out += [list(spilled), alloc.accounting()]
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[1][0] and outs[1][-1]["total"] == 8


# -- park and restore round trips ---------------------------------------------
@pytest.mark.parametrize("case", ["f32", "bf16", "int8", "mla"])
def test_park_restore_round_trip_bit_exact(case):
    """Pages parked to the host pool and restored at a re-admission hold
    every byte they held; the continuation equals a never-parked run."""
    if case == "mla":
        model = Llama(__import__("opsagent_tpu_torch.models.config", fromlist=["x"])
                      .get_config_preset("tiny-mla"), torch.float32, "cpu", seed=0)
    elif case == "bf16":
        model = Llama(TINY_TEST, torch.bfloat16, "cpu", seed=0)
    else:
        model = _model()
    over = dict(kv_quantize="int8" if case == "int8" else "", offload_copy_pages=3)
    eng = _engine(model, **over)
    eng.warmup()
    prompt = [257, 72, 101, 108, 108, 111, 44, 32, 119, 3, 1, 4, 1, 5, 9]
    out1 = _run(eng, prompt, 9)
    hist = prompt + out1[:-1]
    chain = eng.alloc.match_prefix(hist)
    assert len(chain) >= 5   # more than one copy bucket, a partial one last
    before = _pages(eng, chain)
    assert eng.park_chain(hist) == len(chain) * eng.cfg.page_size
    assert eng.alloc.match_prefix(hist) == []
    assert eng.offload_flush() == len(chain)
    page0 = eng.offload.pool.match(hist)[0].data
    assert list(page0) == list(eng.cache.page_leaves())
    prompt2 = hist + [32, 110, 111, 119]
    sid = eng.begin_request(prompt2, SamplingParams(max_tokens=6))
    assert eng._prefilling[sid] == len(chain) * eng.cfg.page_size
    after = _pages(eng, eng.alloc.pages_of(sid)[: len(chain)])
    for name in before:
        assert torch.equal(before[name], after[name]), name
    while sid in eng._prefilling:
        eng.step_mixed([], {sid: 16})
    got = _finish_all(eng, [sid])[0]
    want = _run(_engine(model, **{**over, "offload": False}), prompt2, 6)
    assert got == want
    acc = eng.alloc.accounting()
    assert acc["total"] == eng.cfg.num_pages and acc["host_pool_pages"] == len(chain)
    assert pobs.OFFLOAD_REPREFILL_AVOIDED.value() == len(chain) * eng.cfg.page_size


def test_padded_bucket_lanes_leave_the_cache_as_it_was():
    """A partial bucket pads with the first page id and that page's own
    content: a scatter of pages' own content changes no byte, the other
    pages included."""
    eng = _engine(offload_copy_pages=4)
    _run(eng, list(range(3, 40)), 4)
    whole = {n: leaf.clone() for n, leaf in eng.cache.page_leaves().items()}
    copier = PageCopyEngine(copy_pages=4)
    pages = [5, 2, 7]
    copier.dispatch_gather(eng.cache, pages, [("m", p) for p in pages])
    got = copier.flush(wait=False)
    assert [m for m, _ in got] == [("m", p) for p in pages]
    for (_, p), (_, tree) in zip([("m", p) for p in pages], got):
        for n, leaf in eng.cache.page_leaves().items():
            assert torch.equal(tree[n], leaf[:, p])
    copier.scatter(eng.cache, pages, [t for _, t in got])
    for n, leaf in eng.cache.page_leaves().items():
        assert torch.equal(whole[n], leaf)


# -- pressure parking through the scheduler -----------------------------------
def _tick(sched: Scheduler) -> None:
    """One pass of the scheduler loop's body, on the calling thread."""
    sched._try_admit()
    mixed = sched._mixed_tick()
    sched._reap()
    if sched._running and not mixed:
        sched.engine.step_block(sorted(sched._running))
        sched._reap()


@pytest.mark.parametrize("kvq", ["", "int8"])
def test_pressure_parked_session_matches_never_parked_and_jax(kvq):
    """8 pages: A's decode leaves too few for B's 5-page prompt, so B's
    admission parks A; B finishes, A comes back restored from the host pool
    and gives the never-parked run's tokens and the JAX engine's."""
    kw = dict(num_pages=8, max_pages_per_seq=8, kv_quantize=kvq)
    prompt_a = [257, 3, 1, 4, 1, 5, 9, 2, 6]
    prompt_b = [257] + list(range(60, 76))
    want = _run(_engine(offload=False, **kw), prompt_a, 10)
    jax_want = _jax_engine(kvq).generate([prompt_a], JaxSamplingParams(max_tokens=10))[0]
    assert want == jax_want

    eng = _engine(**kw)
    eng.warmup()
    sched = Scheduler(eng)
    req_a = Request(list(prompt_a), SamplingParams(max_tokens=10))
    sched.submit(req_a)
    sched._drain_queue()
    while req_a.seq_id not in sched._running:
        _tick(sched)
    eng.step_block(sorted(sched._running))
    req_b = Request(list(prompt_b), SamplingParams(max_tokens=4))
    sched.submit(req_b)
    sched._drain_queue()
    sched._try_admit()
    assert req_a.parked and req_a in sched._waiting and req_a.generated_prefix
    assert req_b.seq_id is not None
    assert pobs.OFFLOAD_PARKS.value(trigger="pressure") == 1
    for _ in range(200):
        if req_a.done.is_set() and req_b.done.is_set():
            break
        _tick(sched)
    assert req_b.done.is_set() and not req_b.error
    assert req_a.done.is_set() and not req_a.error
    assert req_a.tokens == want
    assert pobs.flight.get_recorder().snapshot(kind="restore")
    assert not [e for e in pobs.flight.get_recorder().snapshot(kind="anomaly")
                if e.get("reason") == "restore_reprefill"]
    assert eng.alloc.accounting()["owned"] == 0


def test_restore_fallback_reprefills_with_an_anomaly():
    eng = _engine()
    prompt = [257, 8, 6, 7, 5, 3, 0, 9]
    out = _run(eng, prompt, 6)
    hist = prompt + out[:-1]
    assert eng.park_chain(hist) > 0
    eng.offload_flush()
    eng.offload.pool.clear()   # the byte bound dropped everything
    sid = eng.begin_request(hist + [1, 2], SamplingParams(max_tokens=4), expect_restore=True)
    assert eng._prefilling[sid] == 0
    assert [e for e in pobs.flight.get_recorder().snapshot(kind="anomaly")
            if e.get("reason") == "restore_reprefill"]
    assert pobs.OFFLOAD_RESTORE_FALLBACKS.value() == 1
    while sid in eng._prefilling:
        eng.step_mixed([], {sid: 16})
    _finish_all(eng, [sid])
    assert eng.alloc.accounting()["total"] == eng.cfg.num_pages


def test_offload_off_paths_are_noops():
    eng = _engine(offload=False)
    assert eng.offload is None
    assert eng.park_chain([1, 2, 3, 4]) == 0 and eng.offload_flush() == 0
    with pytest.raises(RuntimeError):
        eng.park_sequence(0)


# -- the wire format across the packages ----------------------------------------
def _jax_park(jeng, prompt, max_tokens):
    out = jeng.generate([prompt], JaxSamplingParams(max_tokens=max_tokens))[0]
    hist = prompt + out[:-1]
    jeng.park_chain(hist)
    jeng.offload_flush()
    return hist


@pytest.mark.parametrize("kvq", ["", "int8"])
def test_jax_records_restore_in_the_port(kvq):
    """A JAX engine's parked session, packed by the JAX package, unpacks in
    the port; the port's continuation from the restored pages gives the JAX
    engine's own continuation."""
    jeng = _jax_engine(kvq)
    prompt = [257] + list(range(20, 41))
    hist = _jax_park(jeng, prompt, 7)
    records = jtransfer.pack_entries(jeng.offload.pool.match(hist))
    assert len(records) == len(hist) // 4
    eng = _engine(kv_quantize=kvq)
    pages = ptransfer.unpack_entries(records, eng.cache)
    assert [ppool.chain_key_hex(t) for t, _ in pages] == [
        jpool.chain_key_hex(r["tokens"]) for r in records]
    for (toks, tree), rec in zip(pages, records):
        assert list(tree) == list(eng.cache.page_leaves())
        for leaf, spec in zip(tree.values(), rec["leaves"]):
            assert leaf.numpy().tobytes() == jtransfer.base64.b64decode(spec["data"])
        assert eng.offload.pool.put(toks, tree)
    prompt2 = hist + [33, 44, 55]
    want = jeng.generate([prompt2], JaxSamplingParams(max_tokens=6))[0]
    sid = eng.begin_request(prompt2, SamplingParams(max_tokens=6))
    assert eng._prefilling[sid] == len(records) * 4
    while sid in eng._prefilling:
        eng.step_mixed([], {sid: 16})
    assert _finish_all(eng, [sid])[0] == want


@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
def test_port_records_unpack_in_jax(case):
    model = Llama(TINY_TEST, torch.bfloat16, "cpu", seed=0) if case == "bf16" else _model()
    eng = _engine(model, kv_quantize="int8" if case == "int8" else "")
    prompt = [257] + list(range(70, 90))
    out = _run(eng, prompt, 6)
    hist = prompt + out[:-1]
    eng.park_chain(hist)
    eng.offload_flush()
    entries = eng.offload.pool.match(hist)
    records = ptransfer.pack_entries(entries)
    template = _jax_engine("int8" if case == "int8" else "").cache
    got = jtransfer.unpack_entries(records, template)
    assert len(got) == len(entries)
    for (toks, jtree), e in zip(got, entries):
        assert toks == e.tokens.tolist()
        jleaves = jax.tree_util.tree_leaves(jtree)
        assert len(jleaves) == len(e.data)
        for jl, pl in zip(jleaves, e.data.values()):
            assert np.asarray(jl).shape == tuple(pl.shape)
            assert str(np.asarray(jl).dtype) == DTYPE_NAMES[pl.dtype]
            assert np.asarray(jl).tobytes() == leaf_bytes(pl)
    assert ptransfer.records_nbytes(records) == jtransfer.records_nbytes(records)


def test_corrupt_and_truncated_records_are_rejected():
    jeng = _jax_engine()
    hist = _jax_park(jeng, [257] + list(range(90, 105)), 4)
    records = jtransfer.pack_entries(jeng.offload.pool.match(hist))
    eng = _engine()
    flipped = json.loads(json.dumps(records[0]))
    blob = bytearray(jtransfer.base64.b64decode(flipped["leaves"][0]["data"]))
    blob[len(blob) // 2] ^= 1
    flipped["leaves"][0]["data"] = jtransfer.base64.b64encode(bytes(blob)).decode()
    truncated = dict(records[1], leaves=records[1]["leaves"][:-1])
    malformed = json.loads(json.dumps(records[2]))
    del malformed["digest"]
    malformed["leaves"][0]["shape"] = [3, 3]
    good = ptransfer.unpack_entries([flipped, truncated, malformed, records[3]], eng.cache)
    assert [t for t, _ in good] == [records[3]["tokens"]]
    assert pobs.FLEET_KV_IMPORT_REJECTS.value() == 3
    causes = [e.get("cause") for e in pobs.flight.get_recorder().snapshot(kind="anomaly")
              if e.get("reason") == "kv_import_reject"]
    assert causes == ["digest_mismatch", "structure_mismatch", "malformed_leaf"]


# -- the serving surface ------------------------------------------------------------
def test_tool_time_parking_through_park_session():
    stack = papi.ServingStack(_engine(num_pages=128, max_pages_per_seq=64))
    papi.install_stack("tiny-park", stack)
    try:
        messages = [{"role": "user", "content": "hello world, this is turn one"}]
        resp = stack.chat_completion({"messages": messages, "max_tokens": 6,
                                      "temperature": 0})
        messages.append({"role": "assistant",
                         "content": resp["choices"][0]["message"]["content"] or ""})
        assert papi.park_session("cuda://Tiny-Park", messages) > 0
        assert papi.park_session("cuda://no-such-stack", messages) == 0
        stack.engine.offload_flush()
        assert stack.engine.offload.pool.num_pages > 0
        assert pobs.OFFLOAD_PARKS.value(trigger="tool") == 1
        messages.append({"role": "user", "content": "and now turn two"})
        stack.chat_completion({"messages": messages, "max_tokens": 4, "temperature": 0})
        assert pobs.OFFLOAD_REPREFILL_AVOIDED.value() > 0
    finally:
        papi.uninstall_stack("tiny-park")
        stack.close()


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_fleet_routes_move_a_session_between_two_servers():
    servers = []
    try:
        for _ in range(2):
            stack = papi.ServingStack(_engine(num_pages=128, max_pages_per_seq=64))
            server = papi.make_server(stack, "127.0.0.1", 0)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            servers.append((stack, server, server.server_address[1]))
        (sa, _, pa), (sb, _, pb) = servers
        messages = [{"role": "user", "content": "ship this session to a peer"}]
        body = {"messages": messages, "max_tokens": 6, "temperature": 0}
        first = _http(pa, "/v1/chat/completions", body)
        messages.append({"role": "assistant",
                         "content": first["choices"][0]["message"]["content"]})
        messages.append({"role": "user", "content": "go on"})
        turn2 = {"messages": messages, "max_tokens": 8, "temperature": 0}
        tokens = sa._prompt_ids({"messages": messages[:2]})
        assert _http(pa, "/fleet/digests")["digests"]
        exported = _http(pa, "/fleet/kv/export", {"tokens": tokens, "park": True})
        assert exported["page_size"] == 4 and exported["pages"]
        batched = _http(pa, "/fleet/kv/export", {"chains": [{"tokens": tokens, "start_page": 1}],
                                                 "park": False})
        assert len(batched["results"][0]["pages"]) == len(exported["pages"]) - 1
        assert _http(pa, "/fleet/park", {"tokens": tokens}) == {"parked_tokens": 0}
        imported = _http(pb, "/fleet/kv/import", {"pages": exported["pages"]})
        assert imported == {"imported": len(exported["pages"])}
        got = _http(pb, "/v1/chat/completions", turn2)
        want = _http(pa, "/v1/chat/completions", turn2)
        assert got["choices"][0]["message"] == want["choices"][0]["message"]
        assert sb.engine.offload.restored_pages == len(exported["pages"])
        health = _http(pb, "/healthz")
        assert health["host_pool"]["pages"] == len(exported["pages"])
        assert set(health["init"]) >= {"weights_load_s", "warmup_s", "restore_source",
                                       "snapshot_fingerprint", "kernel_cache_preseeded"}
        assert _http(pb, "/fleet/digests")["page_size"] == 4
    finally:
        for stack, server, _ in servers:
            server.shutdown()
            server.server_close()
            stack.close()
