"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests skip without a GPU. They import neither JAX nor
the JAX package, so they run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Attention tolerances, for both the dma and the grid kernels, are the
reference's own (opsagent_tpu/ops/attention.py:620): 1e-5 in f32, 1e-2 in
bf16 (int8 pages: kernel and plain version both round the dequantized rows
to q's dtype). Quantized matmul: rtol = atol = 1e-3 in f32
(tests/test_quant_matmul_pallas.py's own) and 1e-2 in bf16 (one bf16 ulp is
up to 2^-7 relative), over outputs of unit scale.
"""

from dataclasses import replace

import pytest
import torch

from opsagent_tpu_torch.models.quant import quantize_weight, quantize_weight4
from opsagent_tpu_torch.ops import paged_attention as pa
from opsagent_tpu_torch.ops import quant_matmul as qm
from opsagent_tpu_torch.ops.attention import QuantizedPages, write_kv_pages
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
MM_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _case(gen, B, S, H, K, D, P, starts, q_lens, dtype):
    owned = [-(-(s + q) // P) for s, q in zip(starts, q_lens)]
    max_pages = max(owned) + 1
    N = sum(owned) + 2
    perm = torch.randperm(N, generator=gen, device="cuda").int()
    table = torch.full((B, max_pages), -1, dtype=torch.int32, device="cuda")
    at = 0
    for b, n in enumerate(owned):
        table[b, :n] = perm[at:at + n]
        at += n

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    ints = dict(dtype=torch.int32, device="cuda")
    return (randn(B, S, H, D), randn(N, P, K, D), randn(N, P, K, D), table,
            torch.tensor(starts, **ints), torch.tensor(q_lens, **ints))


# Ragged rows (S: starts, q_lens): each set has a full chunk from position
# 0, a decode row, a q_len 0 row, and a chunk at a longer context that
# starts mid-page and ends off the 64-position chunk grid; at S = 128 a
# full chunk ends at 4096 positions, which the grid form splits while the
# other rows need one split.
RAGGED_ROWS = {
    24: ([0, 37, 5, 300], [24, 1, 0, 17]),
    77: ([0, 130, 3, 1001], [77, 1, 0, 50]),
    128: ([0, 3968, 9, 517, 0], [128, 128, 0, 99, 1]),
}
# Every head dim with P = 4 and 16; G = 2, 4 and 7 (a 64-row tile straddles
# (s, g) boundaries at G = 7).
WIDTHS = [(4, 2, 16, 4), (8, 2, 32, 8), (32, 8, 64, 16), (32, 8, 128, 16),
                 (14, 2, 16, 16), (8, 2, 32, 4), (14, 2, 32, 16), (28, 4, 64, 4),
                 (8, 2, 128, 4), (28, 4, 128, 16)]


def _ragged_case(gen, S, H, K, D, P, dtype):
    starts, q_lens = RAGGED_ROWS[S]
    return _case(gen, len(starts), S, H, K, D, P, starts, q_lens, dtype)


def _assert_zero_rows(got, q_lens):
    """Rows with nothing visible (s >= q_len) are exact zeros."""
    for b, n in enumerate(q_lens.tolist()):
        assert (got[b, n:] == 0).all()


@pytest.mark.parametrize("S", sorted(RAGGED_ROWS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,D,P", WIDTHS)
def test_ragged_kernel_matches_plain(gen, dtype, H, K, D, P, S):
    q, k, v, table, start, q_lens = _ragged_case(gen, S, H, K, D, P, dtype)
    before = pa.LAUNCHES["paged_ragged_attention"]
    got = pa.paged_ragged_attention_cuda(q, k, v, table, start, q_lens)
    want = pa.paged_ragged_attention_cuda(q, k, v, table, start, q_lens, plain=True)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_ragged_attention"] == before + 1
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    _assert_zero_rows(got, q_lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,D,P", [(4, 2, 16, 4), (32, 8, 128, 16)])
def test_decode_kernel_matches_plain(gen, dtype, H, K, D, P):
    lengths = [1, 0, 33, 700]
    q, k, v, table, _, _ = _case(
        gen, 4, 1, H, K, D, P, [max(n - 1, 0) for n in lengths],
        [1 if n else 0 for n in lengths], dtype,
    )
    q = q[:, 0]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = pa.paged_decode_attention_cuda(q, k, v, table, lens)
    want = pa.paged_decode_attention_cuda(q, k, v, table, lens, plain=True)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[1] == 0).all()


def test_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    q, k, v, table, start, q_lens = _case(
        gen, 2, 4, 4, 2, 16, 4, [0, 3], [4, 1], torch.float32
    )
    with pytest.raises(TypeError, match="int32"):
        pa.paged_ragged_attention_cuda(q, k, v, table.long(), start, q_lens)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_ragged_attention_cuda(
            q[..., :8].contiguous(), k[..., :8].contiguous(),
            v[..., :8].contiguous(), table, start, q_lens,
        )


@pytest.mark.parametrize("quantize,kv_quantize", [("", ""), ("int8", "int8"), ("int4", "int8")])
def test_engine_kernel_path_matches_plain_path(gen, quantize, kv_quantize):
    prompts = [[257] + list(range(10, 50)), [257, 5, 6, 7]]
    outs = []
    for impl in ("cuda", "plain"):
        eng = Engine(EngineConfig(model="tiny-test", dtype=torch.float32,
                                  page_size=4, num_pages=64, decode_block=4,
                                  attn_impl=impl, quantize=quantize,
                                  kv_quantize=kv_quantize))
        outs.append(eng.generate(prompts, SamplingParams(max_tokens=12)))
    assert outs[0] == outs[1]


def _quantize_pages(k, v, table, starts, q_lens):
    """int8 copies of the case's pages, written through the plain quantized
    write path from the same rows (each row's visible positions)."""
    N, P, K, D = k.shape
    T = int((starts + q_lens).max())
    slot = torch.arange(T, device="cuda")
    page = table.long().clamp(min=0)[:, (slot // P).clamp(max=table.shape[1] - 1)]
    qk, qv = (QuantizedPages(torch.zeros(N, P, K, D, dtype=torch.int8, device="cuda"),
                             torch.ones(N, P, K, device="cuda")) for _ in range(2))
    # Each row's [T, K, D] rows as they stand in its pages.
    write_kv_pages(qk, qv, k[page, slot % P], v[page, slot % P], table,
                   torch.zeros_like(starts), valid_len=starts + q_lens)
    return qk, qv


@pytest.mark.parametrize("S", sorted(RAGGED_ROWS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,D,P", WIDTHS)
def test_int8_page_kernels_match_plain(gen, dtype, H, K, D, P, S):
    q, k, v, table, start, q_lens = _ragged_case(gen, S, H, K, D, P, dtype)
    qk, qv = _quantize_pages(k, v, table, start, q_lens)
    before = dict(pa.LAUNCHES)
    got = pa.paged_ragged_attention_cuda(q, qk, qv, table, start, q_lens)
    want = pa.paged_ragged_attention_cuda(q, qk, qv, table, start, q_lens, plain=True)
    lens = (start + q_lens).int()
    dgot = pa.paged_decode_attention_cuda(q[:, 0].contiguous(), qk, qv, table, lens)
    dwant = pa.paged_decode_attention_cuda(q[:, 0].contiguous(), qk, qv, table, lens, plain=True)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_ragged_attention_int8"] == before["paged_ragged_attention_int8"] + 1
    assert pa.LAUNCHES["paged_decode_attention_int8"] == before["paged_decode_attention_int8"] + 1
    assert pa.LAUNCHES["paged_ragged_attention"] == before["paged_ragged_attention"]
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (dgot.float() - dwant.float()).abs().max().item() <= TOL[dtype]
    _assert_zero_rows(got, q_lens)


def _weight(gen, In, Out, bits, group):
    w = torch.randn(In, Out, generator=gen, device="cuda")
    return quantize_weight(w) if bits == 8 else quantize_weight4(w, group=group)


# (T, In, Out): T across the m16 / m128 boundary (16, 17) and at the mixed
# ticks' 128 and 1024; the narrow projections that take 64-column blocks
# (bench-8b wk/wv 4096 x 1024, Qwen2.5-7B's 3584 x 512); In = 320, whose
# int4 group of 80 straddles the 64-row stages; Out = 528, an aligned
# column edge inside a block; and shapes the rule sends to the m64 and r16
# instances: a ragged In (300 x 520) and In = 536, whose int4 group of 67
# is odd. At T <= 16, the m16 instance over more than one split: wk/wv
# (16 splits), wd's In = 14336 at T = 1 (56 splits), In = 2960 (its int4
# group of 80 straddles stages; 11 splits) with Out = 528, and wq/wo at
# T = 16 (12 splits).
MM_SHAPES = [(1, 256, 384), (8, 4096, 1024), (96, 300, 520), (5, 64, 512),
             (16, 4096, 1024), (17, 4096, 1024), (128, 4096, 4096), (1024, 4096, 1024),
             (1024, 3584, 512), (128, 320, 528), (64, 536, 256), (8, 300, 520),
             (1, 14336, 512), (8, 2960, 528), (16, 4096, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,group", [(8, 0), (4, 128), (4, 0)])
@pytest.mark.parametrize("T,In,Out", MM_SHAPES)
def test_quant_matmul_kernel_matches_plain(gen, dtype, bits, group, T, In, Out):
    w = _weight(gen, In, Out, bits, group)
    x = torch.randn(T, In, generator=gen, device="cuda").to(dtype)
    x = x / w.dequantize().norm(dim=0).mean()          # outputs of unit scale
    name = f"quant_matmul_int{bits}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instance, _ = qm.plan(T, In, Out, bits, qm._group(w), dtype, sms)
    before = qm.LAUNCHES[name]
    before_instance = qm.INSTANCE_LAUNCHES[f"quant_matmul_{instance}"]
    got = qm.quant_matmul_cuda(x, w)
    want = qm.quant_matmul_cuda(x, w, plain=True)
    torch.cuda.synchronize()
    assert qm.LAUNCHES[name] == before + 1
    assert qm.INSTANCE_LAUNCHES[f"quant_matmul_{instance}"] == before_instance + 1
    odd_group = In == 536 and bits == 4 and group == 128
    assert instance == ("f32" if dtype == torch.float32
                        else ("r16" if T <= 16 else "m64") if In == 300 or odd_group
                        else "m16" if T <= 16 else "m128")
    assert got.dtype == dtype and got.shape == (T, Out)
    tol = MM_TOL[dtype]
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("bits,group", [(8, 0), (4, 128)])
@pytest.mark.parametrize("T,In,Out", [(8, 4096, 14336), (8, 4096, 1024), (1, 14336, 512),
                                      (8, 2960, 528)])
def test_quant_matmul_m16_splits_are_deterministic_and_reset(gen, bits, group, T, In, Out):
    """Two calls give bit-identical y, and every split counter is zero
    again after a call."""
    w = _weight(gen, In, Out, bits, group)
    x = (torch.randn(T, In, generator=gen, device="cuda")
         / w.dequantize().norm(dim=0).mean()).bfloat16()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instance, block_n = qm.plan(T, In, Out, bits, qm._group(w), x.dtype, sms)
    assert instance == "m16" and qm.split_k(T, In, Out, block_n, sms) > 1
    first = qm.quant_matmul_cuda(x, w)
    for _ in range(3):
        again = qm.quant_matmul_cuda(x, w)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
    for (_, partials, _), ws in qm._workspaces.items():
        assert not ws[partials:].view(torch.int32).any()
    want = qm.quant_matmul_cuda(x, w, plain=True)
    tol = MM_TOL[torch.bfloat16]
    assert torch.allclose(first.float(), want.float(), rtol=tol, atol=tol)


def test_quant_matmul_raises_on_what_the_kernel_does_not_take(gen):
    w = _weight(gen, 64, 32, 8, 0)
    with pytest.raises(ValueError, match="In=48"):
        qm.quant_matmul_cuda(torch.randn(2, 48, device="cuda"), w)
    with pytest.raises(TypeError, match="float16"):
        qm.quant_matmul_cuda(torch.randn(2, 64, device="cuda").half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul_cuda(torch.randn(64, 2, device="cuda").t(), w)


# -- grid form (split over the KV sequence) ------------------------------------
@pytest.mark.parametrize("S", sorted(RAGGED_ROWS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,D,P", WIDTHS)
def test_grid_kernels_match_plain(gen, dtype, H, K, D, P, S):
    """The ragged rows of RAGGED_ROWS, and decode rows at each row's
    context (0 for the q_len 0 row), over pages in q's dtype and over int8
    pages."""
    q, k, v, table, start, q_lens = _ragged_case(gen, S, H, K, D, P, dtype)
    lens = torch.where(q_lens > 0, start + q_lens, 0).int()
    qd = q[:, 0].contiguous()
    for suffix, (kp, vp) in (("", (k, v)), ("_int8", _quantize_pages(k, v, table, start, q_lens))):
        before = dict(pa.LAUNCHES)
        got = pa.paged_ragged_attention_grid_cuda(q, kp, vp, table, start, q_lens)
        want = pa.paged_ragged_attention_grid_cuda(q, kp, vp, table, start, q_lens, plain=True)
        dgot = pa.paged_decode_attention_grid_cuda(qd, kp, vp, table, lens)
        dwant = pa.paged_decode_attention_grid_cuda(qd, kp, vp, table, lens, plain=True)
        torch.cuda.synchronize()
        for name in ("paged_ragged_attention_grid", "paged_decode_attention_grid"):
            assert pa.LAUNCHES[name + suffix] == before[name + suffix] + 1
        assert pa.LAUNCHES["paged_ragged_attention"] == before["paged_ragged_attention"]
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
        assert (dgot.float() - dwant.float()).abs().max().item() <= TOL[dtype]
        _assert_zero_rows(got, q_lens)
        assert (dgot[lens == 0] == 0).all()


def _kernel_names(fn) -> list[str]:
    """Names of the CUDA kernels that ``fn`` launches, from the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()]


@pytest.mark.parametrize("long_row", [False, True])
def test_grid_ragged_skips_combine_with_one_split(gen, long_row):
    """A full S = 128 tick of short rows at Qwen2.5-7B's width takes one
    split: the split pass writes the output and no combine runs. A chunk
    ending at 4096 positions takes more splits, and the combine runs."""
    starts = [0, 37, 5, 300, 0, 64, 900, 3968 if long_row else 11]
    q_lens = [128, 1, 0, 17, 128, 128, 99, 128]
    q, k, v, table, start, ql = _case(gen, 8, 128, 28, 4, 128, 16, starts, q_lens,
                                      torch.bfloat16)
    splits, _, ws = pa._grid_plan(q, "ragged", 128, 4, 16, table.shape[1])
    assert (splits > 1) == long_row and (ws is None) == (splits == 1)
    args = (q, k, v, table, start, ql)
    names = _kernel_names(lambda: pa.paged_ragged_attention_grid_cuda(*args))
    assert any("ragged_split_kernel" in n for n in names), names
    assert any("combine_kernel" in n for n in names) == (splits > 1), names
    got = pa.paged_ragged_attention_grid_cuda(*args)
    want = pa.paged_ragged_attention_grid_cuda(*args, plain=True)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]
    _assert_zero_rows(got, ql)


def test_grid_kernels_split_long_decode_and_tolerate_short_tables(gen):
    """A batch of two at 4096 tokens splits over many pages; a length past
    MaxP * P reads the whole table, as the plain version does."""
    q, k, v, table, _, _ = _case(gen, 2, 1, 28, 4, 128, 16, [4095, 100], [1, 1],
                                 torch.float32)
    lens = torch.tensor([4096, 5000], dtype=torch.int32, device="cuda")
    got = pa.paged_decode_attention_grid_cuda(q[:, 0], k, v, table, lens)
    want = pa.paged_decode_attention_grid_cuda(q[:, 0], k, v, table, lens, plain=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL[torch.float32]


@pytest.mark.parametrize("quantize,kv_quantize", [("", ""), ("int8", "int8")])
def test_engine_grid_path_matches_plain_path(gen, quantize, kv_quantize):
    from dataclasses import replace

    from opsagent_tpu_torch.models.config import QWEN25_7B
    from opsagent_tpu_torch.models.llama import Llama

    # Qwen2.5's biases and G = 7, narrowed, with a tied head.
    cfg = replace(QWEN25_7B, num_layers=1, hidden_size=256, intermediate_size=512,
                  num_heads=14, num_kv_heads=2, head_dim=32, vocab_size=512,
                  tie_embeddings=True)
    model = Llama(cfg, torch.float32, "cuda", seed=0, quantize=quantize)
    prompts = [[257] + list(range(10, 50)), [257, 5, 6, 7]]
    outs = []
    for impl in ("cuda", "plain"):
        eng = Engine(EngineConfig(model=cfg.name, dtype=torch.float32, page_size=4,
                                  num_pages=64, decode_block=4, attn_impl=impl,
                                  quantize=quantize, kv_quantize=kv_quantize,
                                  paged_backend="grid"), model_cfg=cfg, model=model)
        before = dict(pa.LAUNCHES)
        outs.append(eng.generate(prompts, SamplingParams(max_tokens=12)))
        grid = [n for n in pa.LAUNCHES if "grid" in n and pa.LAUNCHES[n] > before[n]]
        dma = [n for n in pa.LAUNCHES if "grid" not in n and pa.LAUNCHES[n] > before[n]]
        assert not dma and (bool(grid) == (impl == "cuda"))
    assert outs[0] == outs[1]


# -- both decode forms: the split edges ---------------------------------------
DECODE_FORMS = {
    "dma": (pa.paged_decode_attention_cuda, "paged_decode_attention"),
    "grid": (pa.paged_decode_attention_grid_cuda, "paged_decode_attention_grid"),
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8, 16])
@pytest.mark.parametrize("form", sorted(DECODE_FORMS))
def test_decode_split_edges(gen, form, G, D, dtype, int8):
    """B = 8, K = 8 over a table of 160 pages of 16, so the plan takes
    spans of several 64-position stages (the tensor-core routine's ring
    wraps): lengths 0, 1, P, span - 1, span, span + 1, the full table and
    past it, with a -1 slot inside the full rows' pages. Kernel against
    plain version (with more than one split only the combine writes the
    output); two calls are bit-identical and count one launch each."""
    fn, name = DECODE_FORMS[form]
    B, K, P, max_pages = 8, 8, 16, 160
    H, cap = G * K, max_pages * P
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    splits, span, _ = pa._grid_plan(q, "decode", 1, K, P, max_pages)
    assert splits > 1 and span >= 3 * 64 and span % P == 0
    lengths = [0, 1, P, span - 1, span, span + 1, cap, cap + 37]
    owned = [-(-min(n, cap) // P) for n in lengths]
    N = sum(owned) + 2
    perm = torch.randperm(N, generator=gen, device="cuda").int()
    table = torch.full((B, max_pages), -1, dtype=torch.int32, device="cuda")
    at = 0
    for b, n in enumerate(owned):
        table[b, :n] = perm[at:at + n]
        at += n
    table[6:, 5] = -1      # read as page 0, as the plain version reads it
    k = torch.randn(N, P, K, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(N, P, K, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if int8:
        k, v = _quantize_pages(k, v, table, lens.clamp(max=cap), torch.zeros_like(lens))
    before = pa.LAUNCHES[name + ("_int8" if int8 else "")]
    got = fn(q, k, v, table, lens)
    again = fn(q, k, v, table, lens)
    want = fn(q, k, v, table, lens, plain=True)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name + ("_int8" if int8 else "")] == before + 2
    assert torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[0] == 0).all()


# -- the decode step as a CUDA graph ------------------------------------------
def _graph_and_eager_engines(backend, quantize, kv_quantize):
    """Two engines over one 2-layer bench-1b-width bf16 model: the first
    replays the captured steps, the second runs them eagerly through the
    same kernels."""
    from opsagent_tpu_torch.models.config import BENCH_1B
    from opsagent_tpu_torch.models.llama import Llama

    cfg = replace(BENCH_1B, num_layers=2)
    model = Llama(cfg, torch.bfloat16, "cuda", seed=0, quantize=quantize)
    return [Engine(EngineConfig(model=cfg.name, dtype=torch.bfloat16, page_size=16,
                                num_pages=64, max_pages_per_seq=16, max_batch_size=4,
                                decode_block=8, quantize=quantize,
                                kv_quantize=kv_quantize, paged_backend=backend,
                                cuda_graphs=replay), model_cfg=cfg, model=model)
            for replay in (True, False)]


def _cache_bytes(cache):
    sides = (cache.k, cache.v)
    return [t.clone() for s in sides for t in ((s.q, s.scale) if cache.quantized else (s,))]


def _counters():
    return {**pa.LAUNCHES, **qm.LAUNCHES, **qm.INSTANCE_LAUNCHES}


def _drive_blocks(eng, sampling=SamplingParams(max_tokens=12)):
    """Two prompts admitted through mixed ticks, then a full block (n_steps
    = decode_block); then one sequence leaves, a third arrives, and the
    next block's rows and page table differ, with n_steps < decode_block.
    Per part: tokens, cache bytes and each counter's change."""
    def part(fn):
        before = _counters()
        out = fn()
        torch.cuda.synchronize()
        after = _counters()
        return (out, _cache_bytes(eng.cache),
                {k: n - before[k] for k, n in after.items() if n != before[k]})

    def admit(prompts, sampling):
        ids.extend(eng.add_request(p, sampling) for p in prompts)
        return [eng.sequences[i].tokens[:] for i in ids]

    eng.warmup()
    ids = []
    parts = [part(lambda: admit(([257] + list(range(10, 50)), [257, 5, 6, 7]), sampling))]
    a, b = ids
    parts.append(part(eng.step_block))
    eng.finish(b)
    ids.clear()
    parts.append(part(lambda: admit(([257] + list(range(60, 90)),),
                                    replace(sampling, max_tokens=5))))
    parts.append(part(eng.step_block))
    return parts, (eng.decode_replays, eng.decode_eager_steps, eng.mixed_replays,
                   eng.mixed_eager_ticks), a


@pytest.mark.parametrize("quantize,kv_quantize", [("", ""), ("", "int8"), ("int8", "int8")])
@pytest.mark.parametrize("backend", ["dma", "grid"])
def test_decode_graph_replays_the_eager_step(gen, backend, quantize, kv_quantize):
    """Replayed mixed ticks and blocks give the eager ones' tokens and
    cache bytes bit for bit, the second block reads its new rows and page
    table, and the launch counters change by what the eager steps launch."""
    graph_eng, eager_eng = _graph_and_eager_engines(backend, quantize, kv_quantize)
    got, routes, a = _drive_blocks(graph_eng)
    want, eager_routes, _ = _drive_blocks(eager_eng)
    # Block 1: 8 steps (decode_block); block 2: a has 3 tokens left, the
    # new sequence 4. Admission: one mixed tick a prompt.
    assert [len(got[i][0][a]) for i in (1, 3)] == [8, 3]
    assert routes == (12, 0, 3, 0) and eager_routes == (0, 12, 0, 3)
    layers = graph_eng.model_cfg.num_layers
    form = "_grid" if backend == "grid" else ""
    decode = f"paged_decode_attention{form}{'_int8' if kv_quantize else ''}"
    for i, ((gt, gc, gl), (et, ec, el)) in enumerate(zip(got, want)):
        assert gt == et
        assert all(torch.equal(x, y) for x, y in zip(gc, ec))
        assert gl == el
        if i in (1, 3):
            n = (8, 4)[i // 2]
            assert gl[decode] == layers * n
            if quantize:
                assert gl["quant_matmul_m16"] == (7 * layers + 1) * n


@pytest.mark.parametrize("backend", ["dma", "grid"])
def test_sampled_replays_are_deterministic(gen, backend):
    """Sampled mixed ticks and blocks replay with the engine's generator
    registered: two engines with the same seed give the same tokens and
    cache bytes, and no step runs eagerly."""
    runs = []
    for _ in range(2):
        eng, _ = _graph_and_eager_engines(backend, "", "")
        parts, routes, _ = _drive_blocks(
            eng, SamplingParams(temperature=0.9, top_p=0.95, max_tokens=12))
        runs.append((parts, routes))
    (p1, r1), (p2, r2) = runs
    assert r1 == r2 == (12, 0, 3, 0)
    for (t1, c1, l1), (t2, c2, l2) in zip(p1, p2):
        assert t1 == t2 and l1 == l2
        assert all(torch.equal(x, y) for x, y in zip(c1, c2))


def test_decode_graph_raises_when_a_buffer_moves(gen):
    """A state buffer rebound after capture makes the next block raise,
    not read the old buffer and not run eagerly."""
    eng, _ = _graph_and_eager_engines("dma", "", "")
    eng.warmup()
    eng.add_request([257, 5, 6, 7], SamplingParams(max_tokens=4))
    eng._decode.tok = eng._decode.tok.clone()
    with pytest.raises(RuntimeError, match="moved after capture"):
        eng.step_block()
    assert eng.decode_eager_steps == 0


def test_failed_capture_raises_from_warmup(gen):
    """A decode step that syncs with the host cannot be captured: warmup
    raises (in a process of its own, so the failed capture leaves nothing
    behind for the other tests)."""
    import subprocess
    import sys
    from pathlib import Path

    script = (
        "import torch\n"
        "from opsagent_tpu_torch.models.llama import Llama\n"
        "from opsagent_tpu_torch.serving.engine import Engine, EngineConfig\n"
        "step = Llama.decode_step\n"
        "def syncing(self, *args, **kwargs):\n"
        "    logits = step(self, *args, **kwargs)\n"
        "    logits.sum().item()\n"
        "    return logits\n"
        "Llama.decode_step = syncing\n"
        "eng = Engine(EngineConfig(model='tiny-test', dtype=torch.float32, num_pages=16))\n"
        "try:\n"
        "    eng.warmup()\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__)\n"
        "    raise SystemExit(0)\n"
        "raise SystemExit('warmup did not raise')\n"
    )
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=600)
    assert res.returncode == 0 and "raised" in res.stdout, res.stdout + res.stderr
