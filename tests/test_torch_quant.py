"""The port's weight and KV quantization and its plain quantized matmul
against the JAX package's, on the CPU.

Same numpy inputs (seeded) through both. Quantization is f32 arithmetic in
both packages, so codes are equal exactly and scales to 1e-7. The plain
``quant_matmul`` is held against ``quant_matmul_pallas`` in interpret mode at
the JAX test's shapes (tests/test_quant_matmul_pallas.py), f32 to 1e-3, that
test's own tolerance for sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import quant as jquant
from opsagent_tpu.ops import attention as jattn
from opsagent_tpu.ops.quant_matmul_pallas import quant_matmul_pallas
from opsagent_tpu_torch.models import quant as tquant
from opsagent_tpu_torch.ops import attention as tattn
from opsagent_tpu_torch.ops import quant_matmul as qm
from opsagent_tpu_torch.ops.quant_matmul import plan, quant_matmul, quant_matmul_cuda, split_k

SCALE_TOL = 1e-7


def _weights(seed, In, Out):
    return np.random.default_rng(seed).standard_normal((In, Out)).astype(np.float32)


def _assert_same_quantization(got, want):
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(
        got.scale.numpy(), np.asarray(want.scale), rtol=SCALE_TOL, atol=0
    )


@pytest.mark.parametrize("In,Out", [(64, 128), (300, 256), (4096, 32)])
def test_quantize_weight_matches_jax(In, Out):
    w = _weights(0, In, Out)
    w[:, 3] = 0.0   # an all-zero channel takes scale 1
    got = tquant.quantize_weight(torch.from_numpy(w))
    want = jquant.quantize_weight(jnp.asarray(w))
    assert got.q.dtype == torch.int8 and tuple(got.scale.shape) == (1, Out)
    _assert_same_quantization(got, want)
    np.testing.assert_allclose(
        got.dequantize().numpy(), np.asarray(want.dequantize()), rtol=SCALE_TOL, atol=0
    )


@pytest.mark.parametrize("In,Out,group", [
    (256, 128, 128),    # two groups
    (64, 32, 128),      # contraction < group: one group
    (4544, 16, 128),    # 128 does not divide 4544: groups of 71
    (96, 16, 0),        # group 0: one whole-axis group
])
def test_quantize_weight4_matches_jax(In, Out, group):
    w = _weights(1, In, Out)
    got = tquant.quantize_weight4(torch.from_numpy(w), group=group)
    want = jquant.quantize_weight4(jnp.asarray(w), group=group)
    assert tuple(got.q.shape) == (In // 2, Out)
    assert got.scale.shape == np.asarray(want.scale).shape
    _assert_same_quantization(got, want)
    np.testing.assert_allclose(
        got.dequantize().numpy(), np.asarray(want.dequantize()), rtol=SCALE_TOL, atol=0
    )


def test_group_size_matches_jax():
    for In in (64, 128, 300, 4096, 4544, 14336, 34):
        assert tquant._group_size(In, 128) == jquant._group_size(In, 128)


def test_pack_int4_matches_jax_and_unpacks():
    codes = np.random.default_rng(2).integers(-8, 8, (16, 24)).astype(np.int8)
    got = tquant.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tquant.unpack_int4(got).numpy(), codes)
    with pytest.raises(ValueError, match="even"):
        tquant.pack_int4(torch.zeros(3, 4, dtype=torch.int8))


def test_quantize_params_matches_jax_tree():
    rng = np.random.default_rng(3)
    state = {
        "embed": rng.standard_normal((32, 16)).astype(np.float32),
        "layers.0.attn_norm": np.ones(16, np.float32),
        "layers.0.wq": rng.standard_normal((16, 32)).astype(np.float32),
        "lm_head": rng.standard_normal((16, 32)).astype(np.float32),
    }
    for mode, jfn in (("int8", jquant.quantize_weight), ("int4", jquant.quantize_weight4)):
        got = tquant.quantize_params({k: torch.from_numpy(v) for k, v in state.items()}, mode)
        assert set(got) == {"embed", "layers.0.attn_norm", "layers.0.wq.q",
                            "layers.0.wq.scale", "lm_head.q", "lm_head.scale"}
        assert torch.equal(got["embed"], torch.from_numpy(state["embed"]))
        for name in ("layers.0.wq", "lm_head"):
            want = jfn(jnp.asarray(state[name]))
            np.testing.assert_array_equal(got[f"{name}.q"].numpy(), np.asarray(want.q))
            np.testing.assert_allclose(got[f"{name}.scale"].numpy(), np.asarray(want.scale),
                                       rtol=SCALE_TOL, atol=0)


def test_quantize_kv_rows_matches_jax():
    rng = np.random.default_rng(4)
    new = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3
    new[0, 1, 0] = 0.0   # an all-zero row takes scale 1
    gq, gs = tattn.quantize_kv_rows(torch.from_numpy(new))
    wq, ws = jattn.quantize_kv_rows(jnp.asarray(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=SCALE_TOL, atol=0)
    assert gs[0, 1, 0].item() == 1.0


# -- the plain quantized matmul against the interpret-mode Pallas kernel -----
@pytest.mark.parametrize("T,In,Out", [
    (8, 256, 384), (16, 300, 256), (4, 64, 128), (32, 512, 512), (1, 256, 128),
])
def test_int8_plain_matches_pallas(T, In, Out):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((In, Out)).astype(np.float32)
    x = rng.standard_normal((T, In)).astype(np.float32)
    want = np.asarray(quant_matmul_pallas(
        jnp.asarray(x), jquant.quantize_weight(jnp.asarray(w)), interpret=True
    ))
    tw = tquant.quantize_weight(torch.from_numpy(w))
    got = quant_matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("T,In,Out,group", [
    (8, 256, 384, 128), (16, 256, 256, 256), (4, 64, 128, 128),
    (32, 512, 512, 128), (1, 256, 128, 128),
])
def test_int4_plain_matches_pallas(T, In, Out, group):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((In, Out)).astype(np.float32)
    x = rng.standard_normal((T, In)).astype(np.float32)
    want = np.asarray(quant_matmul_pallas(
        jnp.asarray(x), jquant.quantize_weight4(jnp.asarray(w), group=group),
        interpret=True,
    ))
    tw = tquant.quantize_weight4(torch.from_numpy(w), group=group)
    got = quant_matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_bf16_plain_casts_the_weight_before_the_product():
    """x's dtype rules: the dequantized weight is cast to bf16 first, as the
    oracle does, and the output is bf16."""
    rng = np.random.default_rng(1)
    w = tquant.quantize_weight(torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32)).bfloat16()
    got = quant_matmul(x, w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, x @ w.dequantize().bfloat16())


def test_wrapper_takes_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    for w in (tquant.quantize_weight(torch.randn(64, 48)),
              tquant.quantize_weight4(torch.randn(64, 48), group=32)):
        assert torch.equal(quant_matmul_cuda(x, w), quant_matmul(x, w))


def test_loading_adopts_the_int4_group_count():
    """A model built for int4 holds one whole-axis scale group; loading a
    weight quantized with groups of 32 takes its codes and all G scales."""
    built = tquant.QuantizedLinear4(
        torch.zeros(32, 16, dtype=torch.int8), torch.ones(1, 1, 16)
    )
    w = tquant.quantize_weight4(torch.randn(64, 16), group=32)
    built.load_state_dict({"q": w.q, "scale": w.scale})
    assert built.scale.shape == (2, 1, 16) and built.group == 32
    assert torch.equal(built.dequantize(), w.dequantize())


# -- which kernel instance takes a call, from shapes alone --------------------
H100_SMS = 132
BF16 = torch.bfloat16


@pytest.mark.parametrize("T,In,Out,want", [
    # bench-8b's projections on mixed ticks (T = 8 x bucket, 128..1024):
    # wq/wo, wk/wv, wg/wu, wd.
    (1024, 4096, 4096, ("m128", 128)), (128, 4096, 4096, ("m128", 64)),
    (1024, 4096, 1024, ("m128", 64)), (128, 4096, 1024, ("m128", 64)),
    (1024, 4096, 14336, ("m128", 128)), (128, 4096, 14336, ("m128", 128)),
    (1024, 14336, 4096, ("m128", 128)), (128, 14336, 4096, ("m128", 64)),
    # Qwen2.5-7B's: wq/wo, wk/wv, wg/wu, wd.
    (1024, 3584, 3584, ("m128", 128)), (1024, 3584, 512, ("m128", 64)),
    (1024, 3584, 18944, ("m128", 128)), (1024, 18944, 3584, ("m128", 128)),
    # Decode steps and the lm_head (T = B = 8), and the T boundary: m16's
    # blocks are 128 columns wide where Out / 128 tiles fill half the SMs.
    (8, 4096, 14336, ("m16", 128)), (8, 4096, 128256, ("m16", 128)),
    (8, 4096, 4096, ("m16", 64)), (8, 14336, 4096, ("m16", 64)),
    (8, 3584, 18944, ("m16", 128)), (8, 3584, 152064, ("m16", 128)),
    (16, 4096, 1024, ("m16", 64)), (17, 4096, 1024, ("m128", 64)),
    # Aligned edges: In % 8 == 0, Out % 16 == 0 and not a multiple of 64.
    (96, 64, 64, ("m128", 64)), (96, 320, 528, ("m128", 64)),
    # Unaligned: In % 8 or Out % 16.
    (96, 300, 520, ("m64", 64)), (96, 300, 512, ("m64", 64)),
    (96, 320, 520, ("m64", 64)),
    # The same at T <= 16: r16.
    (8, 300, 520, ("r16", 64)), (1, 300, 512, ("r16", 64)), (16, 320, 520, ("r16", 64)),
    (8, 64, 64, ("m16", 64)), (8, 320, 528, ("m16", 64)),
])
def test_plan_routes_by_shape(T, In, Out, want):
    assert plan(T, In, Out, 8, In, BF16, H100_SMS) == want
    # int4 with groups of 128 (a stage-sized even group) and one whole-axis
    # group takes the same instance.
    assert plan(T, In, Out, 4, tquant._group_size(In, 128), BF16, H100_SMS) == want
    assert plan(T, In, Out, 4, In, BF16, H100_SMS) == want


@pytest.mark.parametrize("T,In,Out,group,want", [
    (128, 320, 528, 80, "m128"),    # even group that a 64-row stage straddles
    (128, 536, 256, 67, "m64"),     # odd group: a byte's two rows may differ
    (128, 64, 256, 8, "m64"),       # group < 16: a stage touches > 5 rows
    (8, 320, 528, 80, "m16"),       # the same at a decode step
    (8, 536, 256, 67, "r16"),
    (8, 64, 256, 8, "r16"),
])
def test_plan_routes_int4_groups(T, In, Out, group, want):
    assert plan(T, In, Out, 4, group, BF16, H100_SMS)[0] == want


def test_plan_takes_f32_by_dtype_and_uses_the_sm_count():
    assert plan(1024, 4096, 4096, 8, 4096, torch.float32, H100_SMS) == ("f32", 64)
    assert plan(8, 4096, 4096, 4, 128, torch.float32, H100_SMS) == ("f32", 64)
    # wk/wv at T = 1024 is 64 blocks of 128 columns: half of 128 SMs, not
    # of 132.
    assert plan(1024, 4096, 1024, 8, 4096, BF16, 128) == ("m128", 128)
    assert plan(1024, 4096, 1024, 8, 4096, BF16, 129) == ("m128", 64)


# -- the m16 instance's split of the contraction axis --------------------------
@pytest.mark.parametrize("In,Out", [
    (4096, 128256), (3584, 152064),              # the lm_heads fill the card
    (64, 64), (64, 128), (128, 64), (64, 512),   # tiny-test: one or two stages
])
def test_split_k_takes_one_split_where_it_gains_nothing(In, Out):
    block_n = plan(8, In, Out, 8, In, BF16, H100_SMS)[1]
    assert split_k(8, In, Out, block_n, H100_SMS) == 1


@pytest.mark.parametrize("In,Out", [
    (4096, 14336), (4096, 4096), (14336, 4096), (4096, 1024),   # bench-8b wg, wq, wd, wk
    (3584, 18944), (3584, 512), (18944, 3584),                  # Qwen2.5-7B wg, wk, wd
])
def test_split_k_splits_the_decode_projections(In, Out):
    for T in (1, 8, 16):
        block_n = plan(T, In, Out, 8, In, BF16, H100_SMS)[1]
        splits = split_k(T, In, Out, block_n, H100_SMS)
        assert splits > 1
        # The kernel shares the stages out evenly: the shortest split has
        # stages // splits of them.
        assert -(-In // qm.STAGE_ROWS) // splits >= qm.M16_MIN_STAGES
        # No more blocks than the waves the rule aims at, unless a split
        # would be shorter than the minimum.
        assert splits * -(-Out // block_n) <= qm.M16_WAVES * qm.M16_BLOCKS_PER_SM * H100_SMS


def test_split_k_follows_the_sm_count_and_the_stage_minimum():
    # bench-8b wg: 112 column tiles of 128; 2 waves of 3 blocks on 132 SMs.
    assert split_k(8, 4096, 14336, 128, H100_SMS) == 792 // 112
    assert split_k(8, 4096, 14336, 128, 66) == 396 // 112
    # bench-8b wk: 16 column tiles of 64 would take 49 splits; 64 stages
    # allow 16 of at least 4 stages.
    assert split_k(8, 4096, 1024, 64, H100_SMS) == 16
    # In = 320: 5 stages, one split; In = 640: 10 stages, two.
    assert split_k(8, 320, 528, 64, H100_SMS) == 1
    assert split_k(8, 640, 528, 64, H100_SMS) == 2


def test_ablation_variants_apply_to_the_kernel_source():
    """scripts/ablate_quant_matmul.py edits the kernel's source by string;
    every variant still finds what it edits."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "ablate_quant_matmul.py"
    spec = importlib.util.spec_from_file_location("ablate_quant_matmul", path)
    ablate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablate)
    base = ablate.edited_source("base")
    for name in ablate.VARIANTS:
        assert (ablate.edited_source(name) == base) == (name == "base")
