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

At a mesh (``parallel.mesh``) the model is this rank's shard and every
rank is called with the same global batch, of which it takes its P(dp,
sp) slice, as JAX's step takes its data sharded P(dp, sp):

- tp and ep shard the weights as the serve path does; the collectives'
  differentiable forms (``parallel.collectives``) give each rank its
  shards' gradients;
- sp splits the sequence: attention is the sp ring with
  ``ring_attention``, else K/V gathered over sp, as XLA does;
- pp runs the GPipe schedule over ``pp_microbatches``
  (``parallel.pipeline``);
- the loss is the global token-mean (the nll sums and token counts added
  over dp and sp before the division), and at pp = 1 the balance loss is
  the whole batch's statistic, as under GSPMD;
- the gradients are summed over dp and sp, and those of the parameters
  replicated over pp over pp; ``grad_norm`` is the norm of the whole
  unsharded tree; the clip and AdamW then run on each shard.

Only full-precision weights train; JAX's ``init_params`` is float-only too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.config import ModelConfig
from ..models.llama import Llama, check_stages, param_specs, staged, state_specs
from ..parallel.collectives import reduce_sum
from ..parallel.mesh import AXES, AXIS_ORDER, Mesh
from ..parallel.pipeline import (
    local_batch,
    make_pipeline_loss,
    nll_sum,
    param_specs_pp,
    sequence_attention,
)


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
    # Ring attention over the sp axis (context parallelism): K/V shards
    # rotate instead of the whole sequence's K/V being gathered. No effect
    # at sp = 1; the pipeline rings whenever sp > 1, as JAX's does.
    ring_attention: bool = False
    # Microbatches of the GPipe schedule when the mesh has pp > 1; the
    # bubble is (pp - 1) / (microbatches + pp - 1).
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
    parameter without them: serving never differentiates). With a ``mesh``
    of several ranks the model is this rank's shard (``train_param_specs``):
    drawn from the seed as slices of the one-rank model, or a whole
    ``model`` sliced by ``load_full_state_dict``. A quantized model is
    refused."""
    if mesh is not None and mesh.size > 1:
        if model is None:
            model = Llama(cfg, dtype, device, seed=seed, mesh=mesh)
        elif model.mesh is None:
            whole = model
            model = Llama(cfg, whole.dtype, whole.embed.device, seed=None,
                          quantize=whole.quantize, mesh=mesh)
            with torch.no_grad():
                model.load_full_state_dict(whole.state_dict())
        elif model.mesh.shape != mesh.shape or model.mesh.coords != mesh.coords:
            raise ValueError(f"the model is sharded over {model.mesh.shape}, not {mesh.shape}")
    elif model is None:
        model = Llama(cfg, dtype, device, seed=seed)
    if model.quantize:
        raise ValueError(
            f"training needs full-precision weights; the model holds {model.quantize}"
        )
    for p in model.parameters():
        p.requires_grad_(p.is_floating_point())
    return model, make_optimizer(model, tc)


def train_param_specs(cfg: ModelConfig, mesh: Mesh) -> dict:
    """JAX's ``train_param_specs``: the pp-staged specs when the mesh
    pipelines (raising JAX's errors when the stack does not divide over
    pp), the serving specs otherwise."""
    pp = mesh.shape.get(AXES.pp, 1)
    if pp > 1:
        check_stages(cfg, pp)
        return param_specs_pp(cfg)
    return param_specs(cfg)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the square root of every leaf's summed
    squares, added leaf by leaf."""
    total = None
    for g in grads:
        sq = (g * g).sum()
        total = sq if total is None else total + sq
    return total.sqrt()


def _sharded_loss(model: Llama, tc: TrainConfig, tokens: torch.Tensor,
                  loss_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward and backward at pp = 1 on this rank's P(dp, sp) slice:
    each rank descends its nll sum over the global token count plus its
    share of the balance loss, so the shares add up over dp and sp to JAX's
    loss. Returns the global (ce, moe_aux)."""
    mesh = model.mesh
    tok, tgt, msk = local_batch(tokens, loss_mask, mesh)
    B, S = tok.shape
    sp = mesh.shape[AXES.sp]
    count = loss_mask[:, 1:].float().sum().clamp_min(1.0)
    attention = sequence_attention(mesh, S * sp, tc.ring_attention)
    attn_fn = model.full_attention(B, S, mesh.coords[AXES.sp] * S, attention)
    x, aux = model.hidden(model._embed(tok), attn_fn, remat=tc.remat,
                          data_axes=(AXES.dp, AXES.sp))
    nll = nll_sum(model.head(x), tgt, msk)
    (nll / count + tc.moe_aux_weight * aux).backward()
    sums = reduce_sum(torch.stack([nll.detach(), aux.detach().float()]), mesh,
                      (AXES.dp, AXES.sp))
    return sums[0] / count, sums[1]


def _sync_grads(model: Llama, mesh: Mesh, named: list[tuple[str, torch.Tensor]]) -> None:
    """Sum each rank's gradient share: over dp and sp for every parameter
    (each rank saw its slice of the batch), and over pp for those every
    stage holds (the embedding, head, final norm, a MoE model's dense
    prefix: zeros on the stages that do not use them), in one order on
    every rank of each group."""
    for name, p in named:
        g = reduce_sum(p.grad, mesh, (AXES.dp, AXES.sp))
        if not staged(model.cfg, name):
            g = reduce_sum(g, mesh, AXES.pp)
        if g is not p.grad:
            p.grad.copy_(g)


def sharded_norm(model: Llama, named: list[tuple[str, torch.Tensor]]) -> torch.Tensor:
    """The global norm of the whole unsharded gradient tree, in f32: each
    shard's squares weighted by 1 / (the ranks holding that shard), then
    summed over every axis, so that each element counts once."""
    mesh = model.mesh
    specs = state_specs(model.cfg, model.quantize)
    total = torch.zeros((), dtype=torch.float32, device=model.embed.device)
    for name, p in named:
        axes = {a for a in specs[name] if a is not None}
        if staged(model.cfg, name):
            axes.add(AXES.pp)
        holders = mesh.size // math.prod(mesh.shape[a] for a in axes)
        total = total + p.grad.float().square().sum() / holders
    return reduce_sum(total, mesh, AXIS_ORDER).sqrt()


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """The train step: ``step(model, optimizer, tokens [B, S], loss_mask
    [B, S]) -> {"loss", "moe_aux", "grad_norm"}`` (0-d tensors on the
    model's device; nothing waits for the card). ``tokens`` is shifted
    for the next-token targets on the logits, so the forward sees the
    whole sequence; ``loss_mask`` marks the target positions that count.
    ``loss`` is the cross entropy; the step descends ``loss + moe_aux_weight
    · moe_aux``; ``grad_norm`` is the norm before clipping. A sharded model
    (``model.mesh``) takes the mesh path of the module docstring; every
    rank is called with the same global batch, and a lost peer makes the
    step raise at the group timeout."""
    def step(model: Llama, optimizer: torch.optim.AdamW, tokens: torch.Tensor,
             loss_mask: torch.Tensor) -> dict[str, torch.Tensor]:
        device = model.embed.device
        tokens = tokens.to(device).long()
        loss_mask = loss_mask.to(device)
        mesh = model.mesh
        names = {id(p): n for n, p in model.named_parameters()}
        params = [p for group in optimizer.param_groups for p in group["params"]]
        for p in params:
            p.grad = None
        if mesh is None:
            logits, aux = model.forward_full(tokens, return_aux=True, remat=tc.remat)
            ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:], loss_mask[:, 1:])
            (ce + tc.moe_aux_weight * aux).backward()
        elif mesh.shape[AXES.pp] > 1:
            run = make_pipeline_loss(cfg, mesh, tc.pp_microbatches, remat=tc.remat,
                                     moe_aux_weight=tc.moe_aux_weight)
            _, (ce, aux) = run(model, tokens, loss_mask)
        else:
            ce, aux = _sharded_loss(model, tc, tokens, loss_mask)
        with torch.no_grad():
            # A parameter the loss does not reach (the sigmoid router's
            # selection bias: top-k passes no gradient; on a pipeline stage
            # the embedding or head it does not use) gets a zero one, so
            # that AdamW decays it and moves its moments as optax does.
            grads = []
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if mesh is None:
                gnorm = global_norm(grads)
            else:
                named = [(names[id(p)], p) for p in params]
                _sync_grads(model, mesh, named)
                gnorm = sharded_norm(model, named)
            # optax's clip_by_global_norm: g / ‖g‖ · max_norm once ‖g‖ ≥
            # max_norm, with no epsilon (clip_grad_norm_ adds 1e-6).
            clip = gnorm >= tc.grad_clip
            for g in grads:
                g.copy_(torch.where(clip, g / gnorm.to(g.dtype) * tc.grad_clip, g))
        optimizer.step()
        return {"loss": ce.detach(), "moe_aux": aux.detach(), "grad_norm": gnorm}

    return step
