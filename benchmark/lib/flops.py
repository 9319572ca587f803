"""Operations and bytes the window's work needs, counted from shapes.

The counts follow the algorithm, not the program: a product of an
[m, k] by a [k, n] matrix is 2mkn operations; attention is 4 * heads *
head_dim * query rows * key rows; a padded row or a finished slot that a
batched round still carries is waste and is not counted.  A mixture of
experts counts its top-k experts only, so a sparse expert path would raise
the share honestly.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 and 3.35 TB/s of HBM3, at
the full 700 W power limit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Dims:
    """The widths of a decoder stack (target or draft)."""

    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    inter: int
    layers: int
    vocab: int
    experts: int = 0
    top_k: int = 0

    @classmethod
    def of(cls, cfg: dict, layers: Optional[int] = None) -> "Dims":
        h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
        return cls(h, nh, cfg["num_key_value_heads"], h // nh, cfg["intermediate_size"],
                   layers if layers is not None else cfg["num_hidden_layers"],
                   cfg["vocab_size"], cfg.get("num_local_experts", 0),
                   cfg.get("num_experts_per_tok", 0))


def layer_row_flops(d: Dims) -> float:
    """One row through one layer's products (projections and the MLP or
    the router and top-k experts), attention scores excluded."""
    qo = 2 * 2 * d.hidden * d.heads * d.head_dim
    kv = 2 * 2 * d.hidden * d.kv_heads * d.head_dim
    if d.experts:
        mlp = 2 * d.hidden * d.experts + d.top_k * 2 * 3 * d.hidden * d.inter
    else:
        mlp = 2 * 3 * d.hidden * d.inter
    return qo + kv + mlp


def attention_flops(heads: int, head_dim: int, q_rows: float, kv_rows: float) -> float:
    return 4.0 * heads * head_dim * q_rows * kv_rows


def head_flops(d: Dims, rows: float) -> float:
    return 2.0 * d.hidden * d.vocab * rows


def prefill_flops(t: Dims, dr: Dims, rows: int, draft_rows: int, top_k: int,
                  depth: int) -> float:
    """A prompt of ``rows`` real rows: the target's layers under causal
    attention and its head at the last row; the draft over its
    ``draft_rows`` and the first tree's expansion."""
    causal = rows * (rows + 1) / 2
    f = rows * t.layers * layer_row_flops(t) + t.layers * attention_flops(
        t.heads, t.head_dim, 1, causal) + head_flops(t, 1)
    dcausal = draft_rows * (draft_rows + 1) / 2
    f += draft_rows * (layer_row_flops(dr) + 2 * 2 * dr.hidden * dr.hidden)
    f += attention_flops(dr.heads, dr.head_dim, 1, dcausal)
    f += expansion_flops(dr, draft_rows, top_k, depth)
    return f


def expansion_flops(dr: Dims, draft_len: float, top_k: int, depth: int) -> float:
    """The draft's beam: the seed row's ranking, then per level top_k rows
    through the layer, the input fuse and the ranking head."""
    f = head_flops(dr, 1)
    for i in range(depth):
        f += top_k * (layer_row_flops(dr) + 2 * 2 * dr.hidden * dr.hidden)
        f += attention_flops(dr.heads, dr.head_dim, top_k, draft_len + (i + 1) * top_k)
        f += head_flops(dr, top_k)
    return f


def round_flops(t: Dims, dr: Dims, tree: int, depth: int, top_k: int,
                target_len: float, draft_len: float, accepted: int) -> float:
    """One live slot's round: the target verifies ``tree`` rows over its
    cache and ranks them with its head; the draft appends the accepted
    rows and grows the next tree."""
    f = tree * t.layers * layer_row_flops(t) + head_flops(t, tree)
    f += t.layers * attention_flops(t.heads, t.head_dim, tree, target_len + depth + 1)
    rows = accepted + 1
    f += rows * (layer_row_flops(dr) + 2 * 2 * dr.hidden * dr.hidden)
    f += attention_flops(dr.heads, dr.head_dim, rows, draft_len + rows)
    return f + expansion_flops(dr, draft_len + rows, top_k, depth)


def tower_flops(vc: dict, patches: int) -> float:
    """The vision tower over one image of ``patches`` patches: the patch
    embedding, every block's products, windowed or full attention, and the
    merger."""
    h, m = vc["hidden_size"], vc["intermediate_size"]
    pin = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    win = (vc["window_size"] // vc["patch_size"]) ** 2
    unit = vc["spatial_merge_size"] ** 2
    f = 2.0 * patches * pin * h
    for i in range(vc["depth"]):
        f += patches * 2 * (h * 3 * h + h * h + 3 * h * m)
        keys = patches if i in vc["fullatt_block_indexes"] else min(win, patches)
        f += attention_flops(1, h, patches, keys)  # heads * head_dim = hidden
    merged = patches // unit
    f += 2.0 * merged * (unit * h) * (unit * h) + 2.0 * merged * unit * h * vc["out_hidden_size"]
    return f


def attention_call(heads: int, kv_heads: int, head_dim: int, q_rows: int, kv_rows: float,
                   attended: float, elem_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one slot's verify-attention call: each live
    K/V row read once per KV head, q read and the output written once;
    ``attended`` key rows per query row for the operations."""
    ops = attention_flops(heads, head_dim, q_rows, attended)
    byts = elem_bytes * head_dim * (2 * kv_heads * kv_rows + 2 * heads * q_rows)
    return ops, byts


def bound_s(ops: float, byts: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(ops / PEAK_BF16_FLOPS, byts / HBM_BYTES_PER_S)


def round_attention_bound_s(t: Dims, dr: Dims, tree: int, depth: int, top_k: int,
                            target_len: float, draft_len: float, accepted: int) -> float:
    """Roofline time of one live slot's verify-attention calls in a round:
    a target call per layer over its cache and the tree block, the draft's
    append over its cache, and one call per expansion level."""
    s = t.layers * bound_s(*attention_call(t.heads, t.kv_heads, t.head_dim, tree,
                                           target_len + tree, target_len + depth + 1))
    rows = accepted + 1
    s += bound_s(*attention_call(dr.heads, dr.kv_heads, dr.head_dim, rows,
                                 draft_len + rows, draft_len + rows))
    s += expansion_attention_bound_s(dr, draft_len + rows, top_k, depth)
    return s


def expansion_attention_bound_s(dr: Dims, draft_len: float, top_k: int, depth: int) -> float:
    s = 0.0
    for i in range(depth):
        kv = draft_len + (i + 1) * top_k
        s += bound_s(*attention_call(dr.heads, dr.kv_heads, dr.head_dim, top_k, kv, kv))
    return s


def sum_rounds(per_round, live: Iterable[Tuple[float, float, List[int]]]) -> float:
    """Sum ``per_round(target_len, draft_len, accepted)`` over each live
    request's rounds, its caches growing by accepted + 1 a round."""
    total = 0.0
    for target_len, draft_len, acc in live:
        for a in acc:
            total += per_round(target_len, draft_len, a)
            target_len += a + 1
            draft_len += a + 1
    return total
