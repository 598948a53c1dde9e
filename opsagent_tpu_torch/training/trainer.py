"""The training step (fine-tuning path) of the llama-family models: the
port's counterpart of ``opsagent_tpu/training/trainer.py``.

One step is the forward over all positions (``Llama.forward_full``, plain
causal attention, no cache: JAX computes it outside any Pallas kernel too,
so training runs no hand-written kernel), the masked next-token cross
entropy plus the weighted MoE balance loss, the backward, optax's
``clip_by_global_norm`` and then AdamW (``torch.optim.AdamW``, which is
optax's ``adamw``: decoupled decay on every parameter, moments in the
parameters' dtype). ``remat`` recomputes each layer's activations in the
backward (JAX's ``jax.checkpoint`` of the scanned layer body).

The port has a device mesh for serving (``parallel.mesh``, ROADMAP item
11 (a)); training's mesh paths (the dp gradient all-reduce, ring
attention's backward, the GPipe schedule over pp, ep in training) wait for
item 11 (b). So it trains as JAX does on a one-device mesh (dp = sp = pp =
1), where ``ring_attention`` and ``pp_microbatches`` have no effect, and
``init_train_state`` refuses a mesh of several ranks. Only full-precision
weights train; JAX's ``init_params`` is float-only too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ModelConfig
from ..models.llama import Llama
from ..parallel.mesh import Mesh


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: bool = True
    # Weight of the MoE router balance loss (Switch-style E·Σ f_e·P_e);
    # the loss is 0 for dense models.
    moe_aux_weight: float = 0.01
    # Ring attention over the sp axis, and GPipe microbatches over pp: no
    # effect without a mesh that has sp > 1 or pp > 1, as in JAX; the
    # port's training takes no such mesh until ROADMAP item 11 (b).
    ring_attention: bool = False
    pp_microbatches: int = 4


def cross_entropy_loss(
    logits: torch.Tensor,   # [B, S, V] float32
    targets: torch.Tensor,  # [B, S] int
    mask: torch.Tensor,     # [B, S] float/bool, 0 for padding positions
) -> torch.Tensor:
    """Token-mean masked cross entropy, in float32: logsumexp minus the
    gold logit, averaged over the mask (the denominator at least 1)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def make_optimizer(model: Llama, tc: TrainConfig) -> torch.optim.AdamW:
    """AdamW over the model's trainable parameters; ``make_train_step``
    clips the gradients by their global norm before each update."""
    return torch.optim.AdamW(
        [p for p in model.parameters() if p.requires_grad], lr=tc.learning_rate,
        betas=(tc.b1, tc.b2), eps=1e-8, weight_decay=tc.weight_decay,
    )


def init_train_state(
    cfg: ModelConfig,
    tc: TrainConfig,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
    model: Llama | None = None,
    mesh: Mesh | None = None,
) -> tuple[Llama, torch.optim.AdamW]:
    """(model, optimizer): a ``Llama`` from ``seed`` on ``device`` (the card
    unless the caller asks for the CPU), or the given ``model``, with
    gradients turned on for its float parameters (the port builds every
    parameter without them: serving never differentiates). A quantized
    model is refused, and so is a ``mesh`` (or a sharded ``model``) of more
    than one rank: the training mesh paths are ROADMAP item 11 (b)."""
    sharded = {a: n for a, n in (mesh.shape if mesh is not None else {}).items() if n > 1}
    if not sharded and model is not None and model.mesh is not None:
        sharded = {a: n for a, n in model.mesh.shape.items() if n > 1}
    if sharded:
        raise ValueError(
            f"training at a mesh over {sharded}: the port trains on one device; the "
            "dp gradient all-reduce, ring attention's backward, the pp schedule and "
            "ep in training wait for ROADMAP item 11 (b)")
    if model is None:
        model = Llama(cfg, dtype, device, seed=seed)
    if model.quantize:
        raise ValueError(
            f"training needs full-precision weights; the model holds {model.quantize}"
        )
    for p in model.parameters():
        p.requires_grad_(p.is_floating_point())
    return model, make_optimizer(model, tc)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the square root of every leaf's summed
    squares, added leaf by leaf."""
    total = None
    for g in grads:
        sq = (g * g).sum()
        total = sq if total is None else total + sq
    return total.sqrt()


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """The train step: ``step(model, optimizer, tokens [B, S], loss_mask
    [B, S]) -> {"loss", "moe_aux", "grad_norm"}`` (0-d tensors on the
    model's device; nothing waits for the card). ``tokens`` is shifted
    for the next-token targets on the logits, so the forward sees the
    whole sequence; ``loss_mask`` marks the target positions that count.
    ``loss`` is the cross entropy; the step descends ``loss + moe_aux_weight
    · moe_aux``; ``grad_norm`` is the norm before clipping."""
    def step(model: Llama, optimizer: torch.optim.AdamW, tokens: torch.Tensor,
             loss_mask: torch.Tensor) -> dict[str, torch.Tensor]:
        device = model.embed.device
        tokens = tokens.to(device).long()
        loss_mask = loss_mask.to(device)
        params = [p for group in optimizer.param_groups for p in group["params"]]
        for p in params:
            p.grad = None
        logits, aux = model.forward_full(tokens, return_aux=True, remat=tc.remat)
        ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:], loss_mask[:, 1:])
        (ce + tc.moe_aux_weight * aux).backward()
        with torch.no_grad():
            # A parameter the loss does not reach (the sigmoid router's
            # selection bias: top-k passes no gradient) gets a zero one, so
            # that AdamW decays it and moves its moments as optax does.
            grads = []
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            gnorm = global_norm(grads)
            # optax's clip_by_global_norm: g / ‖g‖ · max_norm once ‖g‖ ≥
            # max_norm, with no epsilon (clip_grad_norm_ adds 1e-6).
            clip = gnorm >= tc.grad_clip
            for g in grads:
                g.copy_(torch.where(clip, g / gnorm.to(g.dtype) * tc.grad_clip, g))
        optimizer.step()
        return {"loss": ce.detach(), "moe_aux": aux.detach(), "grad_norm": gnorm}

    return step
