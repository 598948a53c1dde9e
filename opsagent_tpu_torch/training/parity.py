"""How one train step is held against a reference step of the same
function (JAX's in the CPU parity tests, one rank's in ``chip_smoke.py``):
the bound of each updated parameter and of AdamW's first moment.

AdamW's first step moves an element by lr · g / (|g| + eps) beside the
decay (eps = 1e-8). Where a gradient cancels to a small fraction of its
tensor's largest, it is mostly summation noise: two summation orders part
it by up to ~5e-6 of that largest (bench-1b's embedding on an H100, one
rank against dp = 2, ``scripts/train_grad_noise.py``), which can flip its
sign or, with |g| near eps, move g / (|g| + eps) anywhere in [0, 1]: the
parameter then parts by up to lr. So an element whose reference gradient
is nonzero and below ``GRAD_NOISE`` of its tensor's largest (the noise
band) is held by its first moment, (1 - b1) times its clipped gradient:
within ``MOMENT_NOISE`` of the tensor's largest moment (twice the largest
difference measured, and half the band's edge, so that a moment of zero
fails in the upper half of the band) plus the grad norm's relative
tolerance of its own (the clip scales every element by the norm). Its
parameter is held only within lr, the most a step moves it. Every other
element's parameter is held within the parameter tolerance: above the
band the noise moves g / (|g| + eps) by at most 0.25 · r · (1 - r) ≤
0.063 of lr. Both band and bounds are read from the reference's moment,
never from the step under test.
"""

from __future__ import annotations

import torch

GRAD_NOISE = 2e-5
MOMENT_NOISE = 1e-5


def noise_band(mu: torch.Tensor, largest: float) -> torch.Tensor:
    """The elements of a reference first moment ``mu`` whose gradient is
    noise: nonzero and below ``GRAD_NOISE`` of ``largest``, the tensor's
    largest |mu|."""
    return (mu != 0) & (mu.abs() < GRAD_NOISE * largest)


def moment_bound(mu: torch.Tensor, largest: float, norm_rtol: float) -> torch.Tensor:
    """How far the first moment under test may lie from the reference's
    ``mu``, element by element."""
    return MOMENT_NOISE * largest + norm_rtol * mu.abs()


def param_bound(band: torch.Tensor, lr: float, param_tol: float) -> torch.Tensor:
    """How far an updated parameter may lie from the reference's: lr in
    the noise band, ``param_tol`` elsewhere."""
    return torch.full(band.shape, param_tol, dtype=torch.float32,
                      device=band.device).masked_fill(band, lr)
