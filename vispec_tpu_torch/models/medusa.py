"""Medusa drafter: per-offset prediction heads on the target's hidden state,
no draft transformer (the JAX package's ``models/medusa.py``).

Five heads, each one residual block ``x + silu(x @ W + b)`` (zero-initialised
linear, so a fresh head is the identity) sharing the target's lm_head.  The
tree comes from the same beam bookkeeping as the ViSpec draft's, but level
i + 1's candidates all come from head i + 1's logits at the same hidden
state: no sequential drafting.  Every function also takes a leading slot
dim (the batched round).  The heads stay whole on every rank of a mesh,
as in the JAX package; only the shared head's logits are gathered.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs import SpecConfig
from ..ops.quant import qdot
from ..ops.topk import top_k
from ..ops.tree import Tree, build_tree
from ..parallel import sharding

NUM_HEADS = 5  # medusa_num_heads


def heads_forward(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [NUM_HEADS, ..., D] residual-block heads; each product
    through ``qdot`` with a float32 result, as JAX's einsum."""
    w, b = params["heads_w"], params["heads_b"]  # [H, D, D], [H, D]
    z = torch.stack([qdot(hidden, w[h]) for h in range(NUM_HEADS)])
    z = z + b.float().reshape((NUM_HEADS,) + (1,) * (hidden.dim() - 1) + (b.shape[-1],))
    return hidden.unsqueeze(0) + F.silu(z).to(hidden.dtype)


def expand_tree(
    params: dict,
    spec: SpecConfig,
    seed_hidden: torch.Tensor,  # [B?, D] target hidden at the frontier token
    sample_token: torch.Tensor,  # [B?] int32
    head_w,  # [D, V] the target's lm_head (plain or quantized)
    mesh=None,  # a vocab-sharded head's logits are gathered over tp
) -> Tree:
    """Beam bookkeeping over the per-head logits: NUM_HEADS - 1 expansion
    levels after the root top-k; level i's candidate pool is head i + 1's
    top-k added to every live beam's score."""
    k_beam = spec.top_k
    levels = NUM_HEADS - 1
    num_cand = k_beam + levels * k_beam * k_beam
    device = seed_hidden.device
    lead = seed_hidden.shape[:-1]

    mh = heads_forward(params, seed_hidden).movedim(0, -2)  # [B?, H, D]
    logp = torch.log_softmax(sharding.vocab_logits(mh, head_w, mesh), dim=-1)  # [B?, H, V]

    top_p0, top_i0 = top_k(logp[..., 0, :], k_beam)
    tokens_flat = torch.zeros((*lead, num_cand), dtype=torch.int32, device=device)
    scores_flat = torch.full((*lead, num_cand), -float("inf"), dtype=torch.float32,
                             device=device)
    parent1_flat = torch.zeros((*lead, num_cand), dtype=torch.int32, device=device)
    tokens_flat[..., :k_beam] = top_i0
    scores_flat[..., :k_beam] = top_p0

    beam_scores = top_p0
    beam_src = torch.arange(k_beam, dtype=torch.int32, device=device)
    for i in range(levels):
        top_p, top_i = top_k(logp[..., i + 1, :], k_beam)  # the same for every beam
        cu = top_p.unsqueeze(-2) + beam_scores.unsqueeze(-1)  # [B?, K beams, K]
        block = k_beam + i * k_beam * k_beam
        flat_scores = cu.reshape(*lead, k_beam * k_beam)
        tokens_flat[..., block:block + k_beam * k_beam] = top_i.repeat(
            *([1] * len(lead)), k_beam)
        scores_flat[..., block:block + k_beam * k_beam] = flat_scores
        parent1_flat[..., block:block + k_beam * k_beam] = (beam_src + 1).unsqueeze(
            -1).expand(*beam_src.shape, k_beam).reshape(*beam_src.shape[:-1], -1)
        beam_scores, cs_idx = top_k(flat_scores, k_beam)
        beam_src = block + cs_idx

    return build_tree(sample_token, tokens_flat, scores_flat, parent1_flat,
                      spec.total_tokens, max_depth=levels + 1)


def init_params(hidden_size: int, device="cuda", dtype=torch.bfloat16) -> dict:
    """Zero-initialised heads: each starts as the identity."""
    return {"heads_w": torch.zeros((NUM_HEADS, hidden_size, hidden_size), dtype=dtype,
                                   device=device),
            "heads_b": torch.zeros((NUM_HEADS, hidden_size), dtype=dtype, device=device)}


def convert_medusa(sd, dtype=torch.bfloat16, device="cuda") -> dict:
    """An HF Medusa state dict (``medusa_head.{i}.0.linear.*``, torch's
    ``[out, in]`` layout; numpy arrays or tensors) -> the heads in the
    ``[in, out]`` layout."""
    def stacked(name, transpose):
        ts = [torch.as_tensor(sd[f"medusa_head.{i}.0.linear.{name}"]).to(device)
              for i in range(NUM_HEADS)]
        return torch.stack([t.T if transpose else t for t in ts]).to(dtype).contiguous()

    return {"heads_w": stacked("weight", True), "heads_b": stacked("bias", False)}
