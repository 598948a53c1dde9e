"""Weight-only int8 / int4 quantization for serving.

The port's counterpart of ``opsagent_tpu/models/quant.py``. A quantized
weight is a small ``nn.Module`` holding two buffers in the JAX layouts, so
a JAX tree carries across unchanged (``models.convert``):

- ``QuantizedLinear``: int8 ``q [in, out]`` and f32 ``scale [1, out]``, one
  symmetric scale per output channel;
- ``QuantizedLinear4``: int4 values packed two per int8 byte along the
  contraction axis, ``q [in/2, out]`` (low nibble = even row, high nibble =
  odd row), and f32 ``scale [G, 1, out]``, one scale per (group of
  ``in / G`` contraction rows, output channel).

``models.llama._mm`` sends every quantized projection through
``ops.quant_matmul.quant_matmul_cuda``. Codes and scales come out of the
same f32 arithmetic as the JAX functions (``torch.round`` rounds half to
even, as ``jnp.round`` does), so both packages quantize a weight to the
same bytes.
"""

from __future__ import annotations

import logging

import torch
from torch import nn

INT4_GROUP = 128  # contraction-axis group size (GPTQ/AWQ convention)

# The large matmuls of a dense Llama; embed and the norms stay in the
# compute dtype (the embedding gather reads one row per token).
_QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd", "lm_head"})


class QuantizedBase(nn.Module):
    """The {q, scale} buffer pair of a quantized weight. ``shape`` is the
    logical ``[in, out]`` of the weight it stands for."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dequantize(self) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # A loaded int4 weight brings its own group count: adopt the
        # incoming scale (and code) shapes before the copy.
        for name in ("q", "scale"):
            new, old = state_dict.get(prefix + name), getattr(self, name)
            if new is not None and new.shape != old.shape:
                setattr(self, name, torch.empty(
                    new.shape, dtype=old.dtype, device=old.device
                ))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class QuantizedLinear(QuantizedBase):
    """int8 weight [in, out] + per-output-channel f32 scale [1, out]."""

    def dequantize(self) -> torch.Tensor:
        return self.q.to(self.scale.dtype) * self.scale


class QuantizedLinear4(QuantizedBase):
    """Packed int4 weight [in/2, out] + group scales [G, 1, out]."""

    @property
    def shape(self) -> torch.Size:
        half, out = self.q.shape
        return torch.Size((2 * half, out))

    @property
    def group(self) -> int:
        return self.shape[0] // self.scale.shape[0]

    def dequantize(self) -> torch.Tensor:
        half, Out = self.q.shape
        In, G = 2 * half, self.scale.shape[0]
        w = unpack_int4(self.q).to(self.scale.dtype).reshape(G, In // G, Out)
        return (w * self.scale).reshape(In, Out)


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-channel int8: scale = absmax / 127 over the
    contraction axis (axis 0 of ``[in, out]``)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return QuantizedLinear(q.to(torch.int8), scale.float())


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[-8, 7]-valued [in, out] -> packed int8 [in/2, out] (even rows in the
    low nibble, odd rows in the high)."""
    In, Out = q.shape
    if In % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {In}")
    q = q.to(torch.int8).reshape(In // 2, 2, Out)
    return (q[:, 1] << 4) | (q[:, 0] & 0x0F)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Packed int8 [in/2, out] -> int8 [in, out]. Arithmetic shifts
    sign-extend: ``(p << 4) >> 4`` is the low nibble, ``p >> 4`` the high."""
    low = (p << 4) >> 4
    high = p >> 4
    return torch.stack([low, high], dim=1).reshape(2 * p.shape[0], p.shape[1])


def _group_size(In: int, group: int) -> int:
    """Largest divisor of ``In`` that is <= ``group``; a contraction dim
    with no divisor in [16, group] falls back to one whole-axis group,
    with a warning."""
    for d in range(min(group, In), 0, -1):
        if In % d == 0:
            if d >= 16:
                return d
            break
    logging.getLogger(__name__).warning(
        "int4 group scaling degraded to ONE whole-axis group for a "
        "%d-wide contraction axis (no divisor in [16, %d])", In, group,
    )
    return In


def quantize_weight4(w: torch.Tensor, group: int = INT4_GROUP) -> QuantizedLinear4:
    """Symmetric group-wise int4: scale = group absmax / 7, values clipped
    to [-7, 7]."""
    In, Out = w.shape
    g = _group_size(In, group) if group else In
    G = In // g
    wg = w.float().reshape(G, g, Out)
    absmax = wg.abs().amax(dim=1, keepdim=True)              # [G, 1, out]
    scale = torch.where(absmax > 0, absmax / 7.0, 1.0)
    q = torch.clamp(torch.round(wg / scale), -7, 7)
    return QuantizedLinear4(pack_int4(q.reshape(In, Out)), scale.float())


def quantize_params(
    state: dict[str, torch.Tensor], mode: str = "int8"
) -> dict[str, torch.Tensor]:
    """Quantize every large linear of a ``Llama`` state dict: an entry
    ``<name>`` whose last part is in ``_QUANT_KEYS`` becomes ``<name>.q``
    and ``<name>.scale``, the state of a model built with ``quantize=mode``.
    Everything else passes through."""
    quant = {"int8": quantize_weight, "int4": quantize_weight4}[mode]
    out: dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if name.rsplit(".", 1)[-1] in _QUANT_KEYS:
            w = quant(t)
            out[f"{name}.q"], out[f"{name}.scale"] = w.q, w.scale
        else:
            out[name] = t
    return out
