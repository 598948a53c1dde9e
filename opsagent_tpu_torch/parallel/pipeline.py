"""Pipeline parallelism (the ``pp`` mesh axis): GPipe microbatch pipelining
of the layer stack for training.

The port's counterpart of ``opsagent_tpu/parallel/pipeline.py``. JAX runs
one uniform program on every stage (a ``lax.scan`` over M + PP - 1 ticks
inside a ``shard_map`` manual over pp, dp and sp, with ``jax.grad``
differentiating the scan); under SPMD each rank is one stage of one (dp,
sp) slice and runs its own part of the schedule:

- Stage s holds the layers ``param_specs_pp`` gives it
  (``models.llama.stage_layers``): L/PP consecutive layers, or for a MoE
  model its share of the MoE stack, the small dense prefix replicated over
  pp and run on stage 0 only. The embedding, final norm and head are
  replicated over pp; stage 0 embeds and the last stage computes the loss.
- Forward: for microbatch m = 0 .. M-1, stage s receives m's activations
  from stage s - 1 (``collectives.recv``; stage 0 embeds its tokens), runs
  its layers under autograd and sends the output to stage s + 1. This is
  JAX's tick t = m + s; a stage computes nothing on the bubble ticks,
  where JAX's stages chew zeros.
- Backward, in reverse microbatch order: the last stage differentiates the
  loss head over the whole batch once, then each stage takes the gradient
  of microbatch m's output (from the head, or received from stage s + 1),
  runs ``torch.autograd.backward`` through its layers for m, and sends the
  gradient of m's input to stage s - 1. The sends and receives of the two
  passes pair up in one order on both sides of every boundary, so blocking
  point-to-point calls cannot deadlock, and the collectives inside a stage
  (tp, ep, the sp ring) run in one order on the ranks of each group.

With sp > 1 a stage's sequence is this rank's S/sp positions, attention is
the sp ring (``parallel.ring.ring_attention``), and the target of a shard's
last position is the next shard's first token. The loss is the last
stage's token-mean over the whole batch (the sums added over pp, dp and
sp). The router balance loss is summed over each stage's microbatches and
divided by M · dp · sp, JAX's statistic (not the whole batch's). The dense
prefix runs on stage 0 only.

The parameter gradients left in ``.grad`` are this rank's share: the
trainer sums them over dp and sp, and the pp-replicated ones over pp
(zeros on the stages that do not use them), as JAX's transpose psums.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.config import ModelConfig
from ..models.llama import Llama, _layer_split, check_stages, param_specs
from .collectives import recv, reduce_sum, send
from .mesh import AXES, Mesh
from .ring import ring_attention


def param_specs_pp(cfg: ModelConfig) -> dict:
    """JAX's ``param_specs_pp``: ``param_specs`` with the pipelined stack's
    leading (layer) axis over ``pp`` (a MoE model's MoE stack; its dense
    prefix, the embedding, the head and the final norm stay replicated)."""
    specs = param_specs(cfg)
    key = "moe_layers" if "moe_layers" in specs else "layers"
    specs[key] = {k: ("pp", *s[1:]) for k, s in specs[key].items()}
    return specs


def local_batch(tokens: torch.Tensor, loss_mask: torch.Tensor, mesh: Mesh
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's P(dp, sp) slice of a global [B, S] batch: (tokens,
    next-token targets, target mask), each [B/dp, S/sp]. The target of
    position j is token j + 1 of the whole row, so a shard's last position
    aims at the next shard's first token; the row's last position has no
    target (mask 0)."""
    B, S = tokens.shape
    dp, sp = mesh.shape[AXES.dp], mesh.shape[AXES.sp]
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    if S % sp:
        raise ValueError(f"sequence {S} not divisible by sp={sp}")
    b, s = B // dp, S // sp
    rows = slice(mesh.coords[AXES.dp] * b, (mesh.coords[AXES.dp] + 1) * b)
    cols = slice(mesh.coords[AXES.sp] * s, (mesh.coords[AXES.sp] + 1) * s)
    pad = tokens.new_zeros(B, 1)
    targets = torch.cat([tokens[:, 1:], pad], dim=1)
    mask = torch.cat([loss_mask[:, 1:].float(), pad.float()], dim=1)
    return tokens[rows, cols], targets[rows, cols], mask[rows, cols]


def nll_sum(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − gold logit) · mask, in f32."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets.long()[..., None])[..., 0]
    return (nll * mask).sum()


def sequence_attention(mesh: Mesh, lengths: int, ring: bool = True):
    """Attention over this rank's S/sp positions: the sp ring (every row
    ``lengths`` long), or, without ``ring``, K/V gathered over sp
    (``ring.gathered_attention``); None (plain causal) at sp = 1."""
    if mesh.shape[AXES.sp] == 1:
        return None
    if ring:
        def attend(q, k, v):
            full = torch.full((q.shape[0],), lengths, dtype=torch.int32, device=q.device)
            return ring_attention(q, k, v, full, mesh)
        return attend
    from .ring import gathered_attention

    return lambda q, k, v: gathered_attention(q, k, v, mesh)


def make_pipeline_loss(
    cfg: ModelConfig,
    mesh: Mesh,
    microbatches: int,
    remat: bool = False,
    moe_aux_weight: float = 0.0,
) -> Callable:
    """Build ``run(model, tokens [B, S], loss_mask [B, S]) -> (loss, (ce,
    aux))`` for this rank's stage ``model`` (``Llama(mesh=mesh)``): the
    GPipe schedule forward and backward over ``microbatches`` microbatches
    of the rank's P(dp, sp) slice of the global batch. On return each
    parameter's ``.grad`` holds this rank's share of the gradient of ``ce +
    moe_aux_weight · aux`` (the module docstring); ``ce`` and ``aux`` are
    the global values, equal on every rank. JAX's arguments but its dtype,
    which the stage model carries. Requires B/dp % microbatches == 0 and
    the stack to divide over pp (JAX's errors)."""
    PP, SP = mesh.shape[AXES.pp], mesh.shape[AXES.sp]
    M = microbatches
    check_stages(cfg, PP)
    dense, _ = _layer_split(cfg)
    stage = mesh.coords[AXES.pp]
    first, last = stage == 0, stage == PP - 1
    share = M * mesh.shape[AXES.dp] * SP

    def run(model: Llama, tokens: torch.Tensor, loss_mask: torch.Tensor):
        tok, tgt, msk = local_batch(tokens, loss_mask, mesh)
        B, S = tok.shape
        if B % M:
            raise ValueError(f"per-dp batch {B} not divisible by microbatches {M}")
        mb = B // M
        count = loss_mask[:, 1:].float().sum().clamp_min(1.0)
        attn_fn = model.full_attention(
            mb, S, mesh.coords[AXES.sp] * S, sequence_attention(mesh, S * SP))
        prefix, mine = [], []
        for i, layer in model.stack():
            (prefix if cfg.moe is not None and i < dense else mine).append((i, layer))
        like = torch.empty(mb, S, cfg.hidden_size, dtype=model.dtype, device=tok.device)
        ins, outs, auxes = [], [], []
        for m in range(M):
            if first:
                x = model._embed(tok[m * mb:(m + 1) * mb])
                if prefix:
                    x, _ = model.hidden(x, attn_fn, prefix, remat)
                ins.append(None)
            else:
                x = recv(like, mesh, AXES.pp, stage - 1).requires_grad_()
                ins.append(x)
            h, aux = model.hidden(x, attn_fn, mine, remat)
            if not last:
                send(h.detach(), mesh, AXES.pp, stage + 1)
            outs.append(h)
            auxes.append(aux)

        nll = torch.zeros((), device=tok.device)
        if last:
            hs = torch.cat([h.detach() for h in outs]).requires_grad_()
            nll = nll_sum(model.head(hs), tgt, msk)
            (nll / count).backward()
            grads = hs.grad.split(mb)
        coef = moe_aux_weight / share
        for m in reversed(range(M)):
            g = grads[m] if last else recv(like, mesh, AXES.pp, stage + 1)
            tensors, seeds = [outs[m]], [g]
            if coef and auxes[m].requires_grad:
                tensors.append(auxes[m])
                seeds.append(torch.full_like(auxes[m], coef))
            torch.autograd.backward(tensors, seeds)
            if not first:
                send(ins[m].grad, mesh, AXES.pp, stage - 1)
            outs[m] = ins[m] = None
        sums = reduce_sum(torch.stack([nll.detach(), torch.stack(auxes).detach().sum().float()]),
                          mesh, (AXES.pp, AXES.dp, AXES.sp))
        ce, aux = sums[0] / count, sums[1] / share
        return ce + moe_aux_weight * aux, (ce, aux)

    return run
