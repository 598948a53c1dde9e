"""Seeded weights, made by the benchmark and handed to both sides.

Each tensor is drawn from a generator of its own, seeded from the run's
seed and the tensor's name, on the device and in the type it is served
in. So the port's set-up and the reference, which rebuilds one layer at a
time after the window, get the same values from the same seed, in any
order. Nothing here knows the port.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

# Init kinds of ``Spec``: "normal" (std fan_in ** -0.5), "norm" (1 + 0.1 N),
# "bias" (0.5 N: large enough that a bias left out moves the logits).
KINDS = ("normal", "norm", "bias")


@dataclass(frozen=True)
class Spec:
    name: str
    shape: tuple[int, ...]
    kind: str = "normal"
    fan_in: int = 0          # "normal": 0 = shape[-2]
    dtype: str = ""          # "" = the served dtype; "float32" for a router


def _seed_of(seed: int, name: str) -> int:
    digest = hashlib.blake2b(f"{int(seed)}:{name}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


class Maker:
    """Draws tensors by ``Spec`` for one seed on one device."""

    def __init__(self, seed: int, device: torch.device | str, dtype: torch.dtype):
        self.seed, self.device, self.dtype = int(seed), torch.device(device), dtype

    def make(self, spec: Spec) -> torch.Tensor:
        if spec.kind not in KINDS:
            raise ValueError(f"{spec.name}: unknown init kind {spec.kind!r}")
        dtype = getattr(torch, spec.dtype) if spec.dtype else self.dtype
        gen = torch.Generator(device=self.device).manual_seed(_seed_of(self.seed, spec.name))
        t = torch.randn(spec.shape, generator=gen, device=self.device, dtype=dtype)
        if spec.kind == "norm":
            return t.mul_(0.1).add_(1.0)
        if spec.kind == "bias":
            return t.mul_(0.5)
        fan_in = spec.fan_in or spec.shape[-2]
        return t.mul_(fan_in ** -0.5)
