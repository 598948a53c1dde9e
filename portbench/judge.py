"""Decides ``correct``: once the window has closed and the port is freed,
a sample of the requests it finished, drawn from the seed with the
longest among them, goes through the family's float32 reference over its
prompt and served tokens (teacher-forced), and each served token's logit
is held against the reference's best at its position. A session's
earlier turns lie inside its latest turn's tokens and are judged in that
one pass. The numbers a cell compares, each within its limit: the widest
gap and the mean gap over the sample's served tokens.

The control puts the reference in the program's place one precision
below the configuration's bf16, computed in fp8 (e4m3) as an fp8 serving
stack would: every projection, expert and lm_head weight rounded with one
absmax scale per output channel, and every activation entering such a
product rounded with one scale per token, the products accumulated in
f32 (attention, norms, the embedding and the f32 router as the reference
has them). It reads, at the same positions, the gap of the token that
this model puts first. (Weights rounded to int8 per channel alone read
within the program's own gaps: PERF.md.)"""

from __future__ import annotations

import numpy as np
import torch

from .weights import Maker, Spec

# The sample holds at least CHECK_MIN sequences the reference reads and
# CHECK_TOKENS served tokens (a cell's own ``tokens``, else this), and at
# most CHECK_MAX sequences.
CHECK_TOKENS = 512
CHECK_MIN = 4
CHECK_MAX = 8


def _read(d: tuple[list[int], list[int]]) -> list[int]:
    """The tokens the reference reads for (prompt, served tokens): the
    prompt and every served token but the last."""
    return d[0] + d[1][:-1]


def sample(done: list[tuple[list[int], list[int]]], seed: int,
           tokens: int = CHECK_TOKENS) -> list[list[int]]:
    """Groups of indices into ``done`` (prompt, served tokens): the
    longest request's, then others' in a seeded order until the sample is
    large enough. A group's first request is the one the reference reads
    (its host); the others are every request whose tokens are a prefix of
    the host's, a session's earlier turns, judged at their own positions
    in the one pass."""
    if not done:
        return []
    reads = [np.asarray(_read(d)) for d in done]

    def inside(j: int, i: int) -> bool:
        n = len(reads[j])
        return n <= len(reads[i]) and np.array_equal(reads[i][:n], reads[j])

    order = np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, 7])).permutation(len(done)).tolist()
    longest = max(range(len(done)), key=lambda i: len(done[i][0]) + len(done[i][1]))
    groups, taken, served = [], set(), 0
    for i in [longest] + [i for i in order if i != longest]:
        if len(groups) >= CHECK_MAX or (served >= tokens and len(groups) >= CHECK_MIN):
            break
        if i in taken:
            continue
        host = max((h for h in range(len(done)) if inside(i, h)), key=lambda h: len(reads[h]))
        group = [host] + [j for j in range(len(done)) if j != host and inside(j, host)]
        taken.update(group)
        groups.append(group)
        served += sum(len(done[j][1]) for j in group)
    return groups


FP8_MAX = 448.0   # float8 e4m3's largest finite value


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one absmax scale along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_control(maker: Maker):
    """The control's (weights, matmul): ``maker``'s weights with every
    matmul weight but the embedding and the f32 router in fp8 per output
    channel, and a product whose activations are rounded to fp8 per token."""
    def make(spec: Spec) -> torch.Tensor:
        t = maker.make(spec).float()
        if spec.kind != "normal" or spec.name == "embed" or spec.dtype:
            return t
        return fp8(t, dim=-2)

    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return fp8(x, dim=-1) @ w

    return make, mm


def gaps(reference, hf: dict, weights, done: list[tuple[list[int], list[int]]],
         groups: list[list[int]], device: torch.device, control=None) -> tuple[dict, dict | None]:
    """The program's gaps and the control's (None without one), each
    {"mean": over every served token of the sampled ``groups``, "max":
    the widest}: by how much the reference's logit of the served token
    (of the control's first token) lies below the reference's best.
    ``control``: (weights, matmul)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        seqs = [_read(done[g[0]]) for g in groups]
        pos = [[len(done[j][0]) - 1 + t for j in g for t in range(len(done[j][1]))]
               for g in groups]
        served = [t for g in groups for j in g for t in done[j][1]]
        with torch.inference_mode():
            ref = reference.logits_at(hf, weights, seqs, pos, device)
            best = torch.cat([lg.max(dim=-1).values for lg in ref])
            logits = torch.cat(ref)

            def shortfall(tokens: torch.Tensor) -> dict:
                g = best - logits.gather(-1, tokens[:, None])[:, 0]
                return {"mean": float(g.mean()), "max": float(g.max())}

            program = shortfall(torch.tensor(served, device=device))
            ctrl = None
            if control is not None:
                low = reference.logits_at(hf, control[0], seqs, pos, device, mm=control[1])
                ctrl = shortfall(torch.cat([lg.argmax(-1) for lg in low]))
        return program, ctrl
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
