"""Device-resident block decode: forward + sample with the loop state on the
card (the port's counterpart of ``opsagent_tpu/serving/decode_loop.py``'s
``decode_block``).

``decode_block`` runs up to ``n_steps`` decode + sample steps. Each row's
last token, write offset and EOS flag stay on the device between steps, and
a row goes inactive on the device when it samples EOS or spends its budget:
inactive rows stop writing KV and emit pad. The host pulls the block's
``[B, n_steps]`` tokens once, at the end, and runs the stop-string checks.
"""

from __future__ import annotations

import torch

from ..models.llama import Llama, PagedKVCache
from .sampler import sample


def decode_block(
    model: Llama,
    tokens: torch.Tensor,       # [B] int last sampled (not yet written) token
    write_at: torch.Tensor,     # [B] int32 tokens already written to cache
    active: torch.Tensor,       # [B] bool
    budgets: torch.Tensor,      # [B] int max tokens each row may emit now
    cache: PagedKVCache,
    page_table: torch.Tensor,   # [B, MaxP] int32, pages pre-booked for the block
    generator: torch.Generator,
    temps: torch.Tensor,        # [B] float32
    top_k: torch.Tensor,        # [B] int
    top_p: torch.Tensor,        # [B] float32
    eos_id: int,
    pad_id: int,
    n_steps: int,
    greedy: bool = False,
    plain: bool = False,
    backend: str = "dma",
) -> torch.Tensor:
    """Returns the block's tokens [B, n_steps] int64 on the device, pad past
    each row's finish. ``greedy`` replaces the sampler with an argmax;
    ``plain`` and ``backend`` pass to ``Llama.decode_step``."""
    tok = tokens.long()
    at = write_at.to(torch.int32)
    act = active & (budgets > 0)
    eos = torch.zeros_like(act)
    out = torch.empty(
        (tok.shape[0], n_steps), dtype=torch.long, device=tok.device
    )
    for step in range(n_steps):
        logits = model.decode_step(tok, at, cache, page_table, act, plain, backend)
        if greedy:
            nxt = logits.argmax(dim=-1)
        else:
            nxt = sample(logits, generator, temps, top_k, top_p)
        nxt = torch.where(act, nxt, tok)
        out[:, step] = torch.where(act, nxt, pad_id)
        at = at + act.to(torch.int32)
        eos = eos | (act & (nxt == eos_id))
        act = act & ~eos & (step + 1 < budgets)
        tok = nxt
    return out
