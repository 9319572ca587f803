"""The speculative decode loop: draft-expand / verify / accept / commit as one
round of device work with no read back to the host.

Every round verifies the drafted tree with the target, walks the tree for
the accepted path (greedy, or rejection sampling at T > 0), commits the
accepted rows to the target cache, appends them to the draft and grows the
next tree.  ``latch_done`` freezes a finished request on the device, so the
host may run rounds ahead of the counters it reads.  The Medusa drafter
(``medusa_prefill``, ``medusa_decode_round``) shares the verify, accept and
commit, and grows its next tree from heads on the target's hidden state.

Sampling draws from the state's ``key`` (``ops/rng.py``, split at prefill
and into three each round, as the JAX package splits its keys), with the
knobs of a static ``SamplingParams`` or, in the per-request mode, the
state's ``samp`` vector; the repetition penalty's ``seen`` mask rides the
state too.  None of it reads the host.

The round also runs B requests at once over a slot-stacked ``SpecState``
(every leaf with a leading slot dim; the batched and serving paths, which
the JAX package gets from ``jax.vmap``): the same code, with per-slot
lengths, trees, keys and caps, and one launch of each kernel per call for
the whole batch.  Prefill and the prefix-snapshot continuation stay
single-request, as in JAX; ``stack_states`` and ``map_states`` move states
in and out of the stacked layout.

Every function takes ``mesh`` (``parallel/mesh.py``) when its parameters
and caches are one rank's shards: the models then sum and gather over the
mesh, the logits are gathered over the vocab before any ranking, and every
rank holds the same state after each round.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..models import draft as draft_mod
from ..models import llama
from ..models import medusa as medusa_mod
from ..models import mixtral
from ..ops import kv_cache as kv
from ..ops import rng
from ..ops.attention import causal_mask
from ..ops.kv_cache import take_rows
from ..ops.sampling import (mark_seen, process_logits, sample_categorical,
                            sample_probs_dyn, update_seen)
from ..ops.tree import Tree, greedy_accept, path_to_root, sampling_accept
from ..utils import profiling


def target_forward(tparams, tcfg, embeds, pos, cache, mask, region=None,
                   return_new_kv=False, seq_len=None, mrope_ids=False, mesh=None):
    """The target backbone's forward: a Mixtral MoE stack when the layers
    hold a ``router``, else the dense Llama (or Qwen2.5-VL text) stack."""
    forward = (mixtral.forward_hidden if "router" in tparams["layers"]
               else llama.forward_hidden)
    return forward(tparams, tcfg, embeds, pos, cache, mask, region, return_new_kv,
                   seq_len=seq_len, mrope_ids=mrope_ids, mesh=mesh)


class SpecState(NamedTuple):
    """Device-resident carry between decode rounds (each leaf with a leading
    slot dim ``[B, ...]`` in the batched layout)."""

    tree: Tree
    target_cache: kv.KVCache
    draft_cache: kv.KVCache
    last_img: torch.Tensor  # [hidden]
    output: torch.Tensor  # [max_out] int32 — tokens generated beyond the prompt
    out_len: torch.Tensor  # [] int32
    new_token: torch.Tensor  # [] int32
    done: torch.Tensor  # [] bool
    fuse_b: torch.Tensor  # [hidden] f32 — folded fuse constant (last_img fixed)
    key: Optional[torch.Tensor] = None  # [] int64 random key (ops/rng.py);
    # None on the greedy paths, which draw nothing
    seen: Optional[torch.Tensor] = None  # [vocab+1] bool committed-token mask
    # of the repetition penalty; None when the penalty is off
    samp: Optional[torch.Tensor] = None  # [4] f32 per-request knobs
    # (temperature, top_p, repetition_penalty, top_k) in the per-request mode
    rope_delta: Optional[torch.Tensor] = None  # [] int32 M-RoPE offset of a
    # Qwen2.5-VL target (negative after an image): decode positions are the
    # cache row + rope_delta; None on a target without mrope_section
    hiddens: Optional[torch.Tensor] = None  # [max_out, hidden] the target's
    # verify hidden of each committed token, indexed like ``output``
    # (keep_hiddens: a finished generation becomes a ConversationSnapshot);
    # None otherwise, and always in the batched layout


def _map_leaf(fn, *xs):
    if xs[0] is None:
        return None
    if isinstance(xs[0], Tree):
        return Tree(*(fn(*ys) for ys in zip(*xs)))
    if isinstance(xs[0], kv.KVCache):
        return kv.KVCache(**{f.name: _map_leaf(fn, *(getattr(x, f.name) for x in xs))
                             for f in dataclasses.fields(kv.KVCache)})
    return fn(*xs)


def map_states(fn, *states: SpecState) -> SpecState:
    """``fn`` over the matching tensor leaves of one or more states (the
    port's ``jax.tree.map``)."""
    return SpecState(*(_map_leaf(fn, *leaves) for leaves in zip(*states)))


def stack_states(states) -> SpecState:
    """Single-request states stacked along a new leading slot dim."""
    return map_states(lambda *xs: torch.stack(xs), *states)


class SamplingParams(NamedTuple):
    """Sampling configuration.  ``per_request=True`` takes per-slot knobs
    from ``SpecState.samp`` (``ops.sampling.sample_probs_dyn``): one pass
    serves a batch mixing greedy and sampled requests; only ``top_k`` stays
    static here, the width of the per-request top-k's sort."""

    temperature: float = 0.0
    top_p: float = 0.0
    top_k: int = 0
    repetition_penalty: float = 1.0  # > 1 penalizes seen tokens
    per_request: bool = False

    @property
    def greedy(self) -> bool:
        return (not self.per_request) and self.temperature <= 1e-5


def _samp_k(samp):
    """The per-request top-k (``samp[..., 3]``) when the knob vector has
    one; a 3-knob vector applies the static bucket to every slot."""
    return samp[..., 3] if samp is not None and samp.shape[-1] > 3 else None


def _probs(logits, sampling: SamplingParams, samp, seen):
    """Sampling probabilities of ``logits [..., V]``: the per-request
    transform, or the static warps and a softmax."""
    if sampling.per_request:
        return sample_probs_dyn(logits, samp[..., 0], samp[..., 1], samp[..., 2], seen,
                                sampling.top_k, top_k_dyn=_samp_k(samp))
    return torch.softmax(process_logits(logits, sampling.temperature, sampling.top_p,
                                        sampling.top_k, sampling.repetition_penalty,
                                        seen), dim=-1)


def _draw_token(logits, sampling: SamplingParams, samp, seen, key):
    """The token after ``logits [V]``: every prefill's first (JAX's
    ``_first_token``) and each AR step's next.  The greedy argmax, or a draw
    from the static or per-request probabilities with a key split off
    ``key`` (a draw over a greedy slot's one-hot is its argmax); marked in
    ``seen``.  Returns (token, key, seen)."""
    if key is not None:
        key, k_sample = rng.split(key, 2)
    if sampling.greedy:
        token = torch.argmax(logits).to(torch.int32)
    else:
        token = sample_categorical(k_sample, _probs(logits, sampling, samp, seen))
    if seen is not None:
        seen = mark_seen(seen, token)
    return token, key, seen


class PromptRope(NamedTuple):
    """A Qwen2.5-VL vision prompt's rotary positions: the M-RoPE ids
    ``[3, pad_len]``, continued over the padding, and ``delta``, the offset
    that every later position adds to its cache row (negative after an
    image)."""

    position_ids: torch.Tensor
    delta: int


def rope_offset(tcfg: LlamaConfig, rope_delta, device) -> Optional[torch.Tensor]:
    """The state's M-RoPE offset: an int32 scalar on a config with
    ``mrope_section`` (0 for a prompt without vision), None otherwise."""
    if tcfg.mrope_section is None:
        return None
    return torch.as_tensor(0 if rope_delta is None else rope_delta,
                           device=device).to(torch.int32).reshape(())


def _prefill_rope(tcfg: LlamaConfig, rope: Optional[PromptRope], pad_len: int, device):
    """(position ids, whether they are 3-row M-RoPE ids, the state's
    ``rope_delta``) of a prefill: the prompt's M-RoPE ids and offset, or
    ``arange(pad_len)`` and 0 (None on a target without ``mrope_section``)."""
    if rope is None:
        return (torch.arange(pad_len, dtype=torch.int32, device=device), False,
                rope_offset(tcfg, 0, device))
    position_ids = torch.as_tensor(rope.position_ids, device=device).to(torch.int32)
    if tuple(position_ids.shape) != (3, pad_len):
        raise ValueError(f"position_ids must be [3, {pad_len}] M-RoPE ids, got "
                         f"{tuple(position_ids.shape)}")
    if tcfg.mrope_section is None:
        raise ValueError("M-RoPE position ids given to a target without mrope_section")
    return position_ids, True, rope_offset(tcfg, rope.delta, device)


def _need_key(key, sampling: SamplingParams):
    if key is None and not sampling.greedy:
        raise ValueError("a sampled prefill needs a random key (ops.rng.key)")


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] along dim 0 for a device-held scalar index, without a host read."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def _rank_head(tparams: dict, dparams: dict):
    """The draft's ranking head: its quantized copy when it has one, else
    the target's own head."""
    return dparams["rank_head"] if "rank_head" in dparams else tparams["lm_head"]


# ---------------------------------------------------------------------------
# Target prefill + first tree
# ---------------------------------------------------------------------------


def spec_prefill(
    tparams: dict,
    dparams: dict,
    tcfg: LlamaConfig,
    dcfg: DraftConfig,
    spec: SpecConfig,
    plan: draft_mod.PrefillPlan,
    sampling: SamplingParams,
    inputs_embeds: torch.Tensor,  # [pad_len, hidden] merged embeds, padded
    target_cache: kv.KVCache,
    draft_cache: kv.KVCache,
    max_out: int,
    max_span: int = 1,
    key: Optional[torch.Tensor] = None,  # [] int64; required unless greedy
    seen: Optional[torch.Tensor] = None,  # [vocab+1] bool prompt-token mask
    samp: Optional[torch.Tensor] = None,  # [4] f32 per-request knobs
    rope: Optional[PromptRope] = None,  # a Qwen2.5-VL vision prompt's positions
    keep_hiddens: bool = False,  # record the committed tokens' verify hiddens
    mesh=None,  # parallel.mesh.Mesh of sharded params and caches
) -> SpecState:
    """Target prompt prefill, first token (the greedy argmax or a draw from
    a key split off ``key``), draft prefill + first tree.  A Qwen2.5-VL
    target's state carries ``rope_delta``, which shifts every later
    position (never the cache rows); the draft keeps its row positions, as
    in the JAX package.  ``keep_hiddens`` gives the state a ``hiddens``
    buffer that each round fills."""
    _need_key(key, sampling)
    pad_len = inputs_embeds.shape[0]
    device = inputs_embeds.device
    real_len = plan.real_len

    position_ids, mrope, rope_delta = _prefill_rope(tcfg, rope, pad_len, device)
    mask = causal_mask(pad_len, target_cache.max_len, 0, device)
    hidden, target_cache = target_forward(tparams, tcfg, inputs_embeds, position_ids,
                                          target_cache, mask, seq_len=real_len,
                                          mrope_ids=mrope, mesh=mesh)
    target_cache = kv.advance(target_cache, real_len)
    last_logits = llama.lm_head(tparams, _take(hidden, real_len - 1), mesh)
    first_token, key, seen = _draw_token(last_logits, sampling, samp, seen, key)

    # draft prefill embeds: shifted merged embeds with the sampled token's
    # embedding at slot real_len-1
    shifted = torch.roll(inputs_embeds, -1, dims=0)
    first_embed = llama.embed(dparams, first_token, mesh).to(shifted.dtype)
    rows = torch.arange(pad_len, device=device)
    shifted = torch.where((rows == real_len - 1)[:, None], first_embed[None], shifted)

    last_hidden, last_img, draft_cache = draft_mod.prefill(
        dparams, dcfg, hidden, shifted, plan, draft_cache, max_span, mesh)
    w_e, w_h, b_eff = draft_mod.decode_fuse_weights(dparams, dcfg, last_img, mesh)
    tree, draft_cache = draft_mod.expand_tree(
        dparams, dcfg, spec, last_hidden, first_token, last_img,
        _rank_head(tparams, dparams), draft_cache, fuse_w=(w_e, w_h, b_eff), mesh=mesh)

    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return SpecState(
        tree=tree,
        target_cache=target_cache,
        draft_cache=draft_cache,
        last_img=last_img,
        output=torch.zeros((max_out,), dtype=torch.int32, device=device),
        out_len=zero(torch.int32),
        new_token=zero(torch.int32),
        done=zero(torch.bool),
        fuse_b=b_eff,
        key=key, seen=seen, samp=samp, rope_delta=rope_delta,
        hiddens=_hiddens_buffer(keep_hiddens, max_out, hidden),
    )


def _hiddens_buffer(keep: bool, max_out: int, hidden: torch.Tensor):
    """The state's ``hiddens`` buffer, in the target hidden's dtype, or None."""
    if not keep:
        return None
    return hidden.new_zeros((max_out, hidden.shape[-1]))


# ---------------------------------------------------------------------------
# Prefix caching (a shared text prefix — e.g. a system prompt — prefilled once)
# ---------------------------------------------------------------------------


class PrefixSnapshot(NamedTuple):
    """Reusable KV + boundary state of a shared TEXT prefix.

    The draft cache holds rows for positions [0, prefix_len-1): the row at
    prefix_len-1 pairs the boundary hidden with the FIRST SUFFIX token's
    embedding, so it cannot be part of the snapshot and is recomputed per
    continuation."""

    t_k: torch.Tensor  # [L, Hkv, prefix_pad, D]
    t_v: torch.Tensor
    d_k: torch.Tensor  # [1, Hkv, prefix_pad, D]
    d_v: torch.Tensor
    prefix_len: torch.Tensor  # [] int32
    boundary_hidden: torch.Tensor  # [hidden] — target hidden at prefix_len-1
    t_ks: Optional[torch.Tensor] = None  # [L, Hkv, prefix_pad] f32 row scales
    t_vs: Optional[torch.Tensor] = None  # when the target cache is int8


def make_prefix_snapshot(
    tparams: dict,
    dparams: dict,
    tcfg: LlamaConfig,
    dcfg: DraftConfig,
    prefix_embeds: torch.Tensor,  # [prefix_pad, hidden]
    prefix_len: torch.Tensor,  # [] int32
    target_cache: kv.KVCache,  # scratch caches, overwritten
    draft_cache: kv.KVCache,
    mesh=None,
) -> PrefixSnapshot:
    """Prefill a shared text prefix once; returns copies of its KV rows and
    the boundary hidden for ``spec_prefill_continue``.  Text only."""
    pad = prefix_embeds.shape[0]
    device = prefix_embeds.device
    pos = torch.arange(pad, dtype=torch.int32, device=device)
    mask = causal_mask(pad, target_cache.max_len, 0, device)
    hidden, tc = target_forward(tparams, tcfg, prefix_embeds, pos, target_cache, mask,
                                seq_len=prefix_len, mesh=mesh)
    boundary = _take(hidden, prefix_len - 1)

    # draft rows for positions [0, prefix_len-1): hidden[i] + embed(token[i+1])
    shifted = torch.roll(prefix_embeds, -1, dims=0)
    x = draft_mod.fuse(dparams, shifted.to(hidden.dtype), hidden,
                       hidden.new_zeros((dcfg.hidden_size,)), mesh)
    rows = torch.arange(pad, dtype=torch.int32, device=device)
    attn = torch.zeros((pad, draft_cache.max_len), dtype=torch.bool, device=device)
    attn[:, :pad] = rows[None, :] <= rows[:, None]
    _, dc = draft_mod.layer_forward(dparams, dcfg, x, rows, draft_cache, 0, attn, mesh=mesh)

    def rows_of(t):  # copies of the first rows: the scratch caches are reused
        return t[..., :pad, :].clone()

    def scales_of(t):
        return None if t is None else t[..., :pad].clone()

    return PrefixSnapshot(
        t_k=rows_of(tc.k), t_v=rows_of(tc.v), d_k=rows_of(dc.k), d_v=rows_of(dc.v),
        prefix_len=torch.as_tensor(prefix_len, device=device).to(torch.int32),
        boundary_hidden=boundary, t_ks=scales_of(tc.k_scale), t_vs=scales_of(tc.v_scale))


def spec_prefill_continue(
    tparams: dict,
    dparams: dict,
    tcfg: LlamaConfig,
    dcfg: DraftConfig,
    spec: SpecConfig,
    sampling: SamplingParams,
    snap: PrefixSnapshot,
    suffix_embeds: torch.Tensor,  # [suffix_pad, hidden]
    suffix_len: torch.Tensor,  # [] int32
    target_cache: kv.KVCache,
    draft_cache: kv.KVCache,
    max_out: int,
    key: Optional[torch.Tensor] = None,
    seen: Optional[torch.Tensor] = None,
    samp: Optional[torch.Tensor] = None,
    keep_hiddens: bool = False,
    mesh=None,
) -> SpecState:
    """``spec_prefill`` for ``prefix + suffix`` that only computes the
    suffix: the snapshot's KV rows are copied into the caches, the target
    runs over the suffix positions, and the draft continues from the
    boundary row.  The same target KV and hiddens as a full prefill (same
    weights, same positions), up to summation order."""
    _need_key(key, sampling)
    device = suffix_embeds.device
    plen = snap.prefix_len
    pad_s = suffix_embeds.shape[0]
    n = snap.t_k.shape[-2]

    # seed the caches with the snapshot rows
    for buf, rows in ((target_cache.k, snap.t_k), (target_cache.v, snap.t_v),
                      (draft_cache.k, snap.d_k), (draft_cache.v, snap.d_v)):
        buf[..., :n, :].copy_(rows)
    if snap.t_ks is not None:
        target_cache.k_scale[..., :n].copy_(snap.t_ks)
        target_cache.v_scale[..., :n].copy_(snap.t_vs)
    target_cache = target_cache._replace(length=plen.clone(), real_length=plen.clone())
    draft_cache = draft_cache._replace(length=(plen - 1).to(torch.int32),
                                       real_length=(plen - 1).to(torch.int32))

    # ---- target forward over the suffix ----
    pos = plen + torch.arange(pad_s, dtype=torch.int32, device=device)
    mask = causal_mask(pad_s, target_cache.max_len, plen, device)
    hidden_s, target_cache = target_forward(tparams, tcfg, suffix_embeds, pos,
                                            target_cache, mask, seq_len=plen + suffix_len,
                                            mesh=mesh)
    target_cache = kv.advance(target_cache, suffix_len)
    last_logits = llama.lm_head(tparams, _take(hidden_s, suffix_len - 1), mesh)
    first_token, key, seen = _draw_token(last_logits, sampling, samp, seen, key)

    # ---- draft continuation over positions [plen-1, plen+suffix_len) ----
    # row j (block-relative) is position plen-1+j: hidden + NEXT token's embed
    first_embed = llama.embed(dparams, first_token, mesh)
    d_embeds = torch.cat([suffix_embeds[:1], torch.roll(suffix_embeds, -1, dims=0)])
    ridx = torch.arange(pad_s + 1, dtype=torch.int32, device=device)
    d_embeds = torch.where((ridx == suffix_len)[:, None],
                           first_embed[None].to(d_embeds.dtype), d_embeds)
    d_hidden = torch.cat([snap.boundary_hidden[None], hidden_s])
    last_img = d_hidden.new_zeros((dcfg.hidden_size,))
    x = draft_mod.fuse(dparams, d_embeds.to(d_hidden.dtype), d_hidden, last_img, mesh)
    d_pos = plen - 1 + ridx
    cols = torch.arange(draft_cache.max_len, dtype=torch.int32, device=device)
    committed = cols[None, :] < draft_cache.length
    in_block = (cols[None, :] >= draft_cache.length) & (
        cols[None, :] <= draft_cache.length + ridx[:, None])
    d_out, draft_cache = draft_mod.layer_forward(
        dparams, dcfg, x, d_pos, draft_cache, draft_cache.length, committed | in_block,
        mesh=mesh)
    draft_cache = kv.advance(draft_cache, suffix_len + 1)
    last_hidden = _take(d_out, suffix_len)

    w_e, w_h, b_eff = draft_mod.decode_fuse_weights(dparams, dcfg, last_img, mesh)
    tree, draft_cache = draft_mod.expand_tree(
        dparams, dcfg, spec, last_hidden, first_token, last_img,
        _rank_head(tparams, dparams), draft_cache, fuse_w=(w_e, w_h, b_eff), mesh=mesh)

    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return SpecState(
        tree=tree, target_cache=target_cache, draft_cache=draft_cache,
        last_img=last_img,
        output=torch.zeros((max_out,), dtype=torch.int32, device=device),
        out_len=zero(torch.int32), new_token=zero(torch.int32),
        done=zero(torch.bool), fuse_b=b_eff, key=key, seen=seen, samp=samp,
        rope_delta=rope_offset(tcfg, None, device),
        hiddens=_hiddens_buffer(keep_hiddens, max_out, hidden_s))


# ---------------------------------------------------------------------------
# One decode round
# ---------------------------------------------------------------------------


def _verify_accept_commit(tparams, tcfg, sampling: SamplingParams, state: SpecState,
                          eos_id, max_new_tokens, max_path: int, max_accept_depth: int,
                          mesh=None):
    """Every drafter's round core: target verify over the tree block, the
    acceptance walk (greedy, or rejection sampling from the state's key),
    KV commit and output append.  Returns (hidden [B?, T, D], path, jcols,
    acc, bonus, target_cache, output, out_len, new_token, done, key, seen)."""
    tree = state.tree
    t = tree.size
    device = tree.tokens.device
    tree_start = state.target_cache.length

    embeds = llama.embed(tparams, tree.tokens, mesh)
    pos = tree_start.unsqueeze(-1) + tree.depth
    if state.rope_delta is not None:
        # M-RoPE: decode positions are 1-D, the cache row + rope_delta, on
        # all three streams alike (where M-RoPE is plain rotary); the
        # kernel's region still starts at the cache row, tree_start
        pos = pos + state.rope_delta.unsqueeze(-1)
    hidden, target_cache, new_kv = target_forward(
        tparams, tcfg, embeds, pos, state.target_cache, None,
        region=(tree_start, tree.mask), return_new_kv=True, seq_len=tree_start + t,
        mesh=mesh)
    logits = llama.lm_head(tparams, hidden, mesh)  # [B?, T, V] float32, whole vocab

    key = state.key
    if sampling.greedy:
        argmax_toks = torch.argmax(logits, dim=-1).to(torch.int32)
        best, acc = greedy_accept(tree, argmax_toks)
        bonus = take_rows(argmax_toks, -1, best.unsqueeze(-1)).squeeze(-1)
    else:
        key, k_accept, k_bonus = rng.split(key, 3)
        probs = _probs(logits, sampling, state.samp, state.seen)
        best, acc, resid = sampling_accept(
            tree, probs, rng.uniform(k_accept, (max_accept_depth, t)), max_accept_depth)
        bonus = sample_categorical(k_bonus, resid)

    path = path_to_root(tree, best, max_path)
    target_cache = kv.commit_from_blocks(target_cache, tree_start, new_kv[0],
                                         new_kv[1], path, acc + 1)

    committed = take_rows(tree.tokens, -1, path)  # rows > acc are padding
    jcols = torch.arange(max_path, dtype=torch.int32, device=device)
    valid = jcols <= acc.unsqueeze(-1)
    eos_hit = torch.any(valid & (committed == eos_id), dim=-1)

    output = state.output.clone()
    kv.write_rows(output, -1, state.out_len, committed)
    out_len = (state.out_len + acc + 1).to(torch.int32)
    new_token = (state.new_token + acc + 1).to(torch.int32)
    done = state.done | eos_hit | (new_token > max_new_tokens)

    seen = state.seen
    if seen is not None:
        # the committed tokens and the bonus (the next tree's root, already
        # part of the sequence) enter the penalty's history after the round
        seen = mark_seen(update_seen(seen, committed, valid), bonus)
    return (hidden, path, jcols, acc, bonus, target_cache, output, out_len,
            new_token, done, key, seen)


def decode_round(
    tparams: dict,
    dparams: dict,
    tcfg: LlamaConfig,
    dcfg: DraftConfig,
    spec: SpecConfig,
    sampling: SamplingParams,
    state: SpecState,
    eos_id,
    max_new_tokens,
    mesh=None,  # parallel.mesh.Mesh of sharded params and caches
) -> SpecState:
    """verify -> accept -> commit -> next draft tree, all on the device.
    The caches are written in place; ``state`` must not be used again except
    through what this returns (as the JAX version donates it).  A
    slot-stacked state runs every slot in the same pass, with
    ``max_new_tokens`` a scalar or a ``[B]`` vector of per-slot caps."""
    max_path = spec.depth + 2
    (hidden, path, jcols, acc, bonus, target_cache, output, out_len,
     new_token, done, key, seen) = _verify_accept_commit(
        tparams, tcfg, sampling, state, eos_id, max_new_tokens, max_path, spec.depth + 1,
        mesh)

    tree = state.tree
    accept_hidden = take_rows(hidden, -2, path)  # [B?, max_path, hidden]
    if state.hiddens is not None:
        # the committed tokens' verify hiddens at their output rows (rows
        # past acc are overwritten by the next live round, as in ``output``)
        kv.write_rows(state.hiddens, -2, state.out_len, accept_hidden)
    nxt = take_rows(tree.tokens, -1, path)
    # row j pairs hidden[path[j]] with token[path[j+1]]; the last valid row
    # (and the padding after it) takes the bonus token
    tok_next = torch.where(jcols < acc.unsqueeze(-1), torch.roll(nxt, -1, dims=-1),
                           bonus.unsqueeze(-1))

    w_e, w_h = draft_mod.ensure_fuse_mats(dparams, dcfg, mesh)
    fuse_w = (w_e, w_h, state.fuse_b)
    with profiling.span("round.draft"):
        seed, draft_cache = draft_mod.append_accepted(
            dparams, dcfg, accept_hidden, tok_next, acc + 1, state.last_img,
            state.draft_cache, fuse_w=fuse_w, mesh=mesh)
        new_tree, draft_cache = draft_mod.expand_tree(
            dparams, dcfg, spec, seed, bonus, state.last_img,
            _rank_head(tparams, dparams), draft_cache, fuse_w=fuse_w, mesh=mesh)

    new_state = state._replace(
        tree=new_tree, target_cache=target_cache, draft_cache=draft_cache,
        output=output, out_len=out_len, new_token=new_token, done=done, key=key,
        seen=seen)
    return latch_done(state, new_state)


def latch_done(prev: SpecState, new: SpecState) -> SpecState:
    """Freeze a finished request after an unconditionally executed round:
    the small cursors, the output, the key and the seen mask are selected on
    ``prev.done``; the big K/V buffers are not — rows written past the
    frozen lengths are unreachable and overwritten by the next live round.
    In the batched layout each slot latches on its own ``done``."""

    def sel(old, upd):
        if upd is None:
            return None
        done = prev.done.reshape(prev.done.shape + (1,) * (old.dim() - prev.done.dim()))
        return torch.where(done, old, upd)

    def sel_cache(old: kv.KVCache, upd: kv.KVCache) -> kv.KVCache:
        return upd._replace(length=sel(old.length, upd.length),
                            real_length=sel(old.real_length, upd.real_length))

    return new._replace(
        tree=Tree(*(sel(o, u) for o, u in zip(prev.tree, new.tree))),
        target_cache=sel_cache(prev.target_cache, new.target_cache),
        draft_cache=sel_cache(prev.draft_cache, new.draft_cache),
        output=sel(prev.output, new.output),
        out_len=sel(prev.out_len, new.out_len),
        new_token=sel(prev.new_token, new.new_token),
        done=prev.done | new.done,
        key=sel(prev.key, new.key),
        seen=sel(prev.seen, new.seen),
    )


# ---------------------------------------------------------------------------
# Medusa (no draft transformer: heads on the target's hidden state)
# ---------------------------------------------------------------------------


def medusa_prefill(
    tparams: dict,
    mparams: dict,
    tcfg: LlamaConfig,
    spec: SpecConfig,
    sampling: SamplingParams,
    inputs_embeds: torch.Tensor,  # [pad_len, hidden]
    real_len,
    target_cache: kv.KVCache,
    max_out: int,
    key: Optional[torch.Tensor] = None,
    samp: Optional[torch.Tensor] = None,
    mesh=None,
) -> SpecState:
    """Target prompt prefill, first token, and the first tree from the heads
    on the last prompt hidden.  The state carries a dummy draft cache of
    8 rows (the JAX package's), which no Medusa round reads.  As in the JAX
    package, every prompt takes plain positions and a zero M-RoPE offset,
    a Qwen2.5-VL vision prompt too."""
    _need_key(key, sampling)
    pad_len = inputs_embeds.shape[0]
    device = inputs_embeds.device
    real_len = torch.as_tensor(real_len, device=device)
    position_ids, mrope, rope_delta = _prefill_rope(tcfg, None, pad_len, device)
    mask = causal_mask(pad_len, target_cache.max_len, 0, device)
    hidden, target_cache = target_forward(tparams, tcfg, inputs_embeds, position_ids,
                                          target_cache, mask, seq_len=real_len,
                                          mrope_ids=mrope, mesh=mesh)
    target_cache = kv.advance(target_cache, real_len)
    last_hidden = _take(hidden, real_len - 1)
    last_logits = llama.lm_head(tparams, last_hidden, mesh)
    first_token, key, _ = _draw_token(last_logits, sampling, samp, None, key)
    tree = medusa_mod.expand_tree(mparams, spec, last_hidden, first_token,
                                  tparams["lm_head"], mesh)

    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return SpecState(
        tree=tree, target_cache=target_cache,
        draft_cache=kv.init_cache(1, 1, 8, 8, inputs_embeds.dtype, device),
        last_img=inputs_embeds.new_zeros((tcfg.hidden_size,)),
        output=torch.zeros((max_out,), dtype=torch.int32, device=device),
        out_len=zero(torch.int32), new_token=zero(torch.int32), done=zero(torch.bool),
        fuse_b=torch.zeros((1,), dtype=torch.float32, device=device),
        key=key, samp=samp, rope_delta=rope_delta)


def medusa_decode_round(
    tparams: dict,
    mparams: dict,
    tcfg: LlamaConfig,
    spec: SpecConfig,
    sampling: SamplingParams,
    state: SpecState,
    eos_id,
    max_new_tokens,
    mesh=None,
) -> SpecState:
    """A Medusa round: the shared verify, accept and commit over a tree of
    depth NUM_HEADS, then the next tree from the heads on the deepest
    accepted node's hidden state.  Slot-stacked states as ``decode_round``."""
    max_path = medusa_mod.NUM_HEADS + 1
    (hidden, path, _, acc, bonus, target_cache, output, out_len,
     new_token, done, key, _) = _verify_accept_commit(
        tparams, tcfg, sampling, state, eos_id, max_new_tokens, max_path,
        medusa_mod.NUM_HEADS, mesh)
    best = take_rows(path, -1, torch.clamp(acc, 0, max_path - 1).unsqueeze(-1))
    best_hidden = take_rows(hidden, -2, best).squeeze(-2)
    new_tree = medusa_mod.expand_tree(mparams, spec, best_hidden, bonus, tparams["lm_head"],
                                      mesh)
    new_state = state._replace(
        tree=new_tree, target_cache=target_cache, output=output, out_len=out_len,
        new_token=new_token, done=done, key=key)
    return latch_done(state, new_state)


# ---------------------------------------------------------------------------
# Autoregressive baseline
# ---------------------------------------------------------------------------


def ar_step(
    tparams: dict,
    tcfg: LlamaConfig,
    sampling: SamplingParams,
    token: torch.Tensor,  # [] int32
    cache: kv.KVCache,
    key: Optional[torch.Tensor] = None,  # required unless greedy
    seen: Optional[torch.Tensor] = None,  # [vocab+1] bool (repetition penalty)
    rope_delta: Optional[torch.Tensor] = None,  # [] int32 M-RoPE offset (Qwen2.5-VL)
    mesh=None,
):
    """One AR decode step over the same KV runtime; returns (next token []
    int32, cache, key, seen).  The penalty's mask updates per token.  The
    token's position is the cache row + ``rope_delta``."""
    _need_key(key, sampling)
    embeds = llama.embed(tparams, token.reshape(1), mesh)
    pos = cache.length.reshape(1)
    if rope_delta is not None:
        pos = pos + rope_delta
    ones = torch.ones((1, 1), dtype=torch.bool, device=token.device)
    hidden, cache = target_forward(tparams, tcfg, embeds, pos, cache, None,
                                   region=(cache.length, ones),
                                   seq_len=cache.length + 1, mesh=mesh)
    cache = kv.advance(cache, 1)
    nxt, key, seen = _draw_token(llama.lm_head(tparams, hidden[0], mesh), sampling, None,
                                  seen, key)
    return nxt, cache, key, seen


def ar_prefill(
    tparams: dict,
    tcfg: LlamaConfig,
    sampling: SamplingParams,
    inputs_embeds: torch.Tensor,  # [pad_len, hidden]
    real_len,
    cache: kv.KVCache,
    key: Optional[torch.Tensor] = None,
    seen: Optional[torch.Tensor] = None,
    rope: Optional[PromptRope] = None,  # a Qwen2.5-VL vision prompt's positions
    mesh=None,
):
    """Prompt prefill for the AR baseline; returns (first token, cache, key,
    seen, the ``rope_delta`` that ``ar_step`` takes)."""
    _need_key(key, sampling)
    pad_len = inputs_embeds.shape[0]
    device = inputs_embeds.device
    real_len = torch.as_tensor(real_len, device=device)
    pos, mrope, rope_delta = _prefill_rope(tcfg, rope, pad_len, device)
    mask = causal_mask(pad_len, cache.max_len, 0, device)
    hidden, cache = target_forward(tparams, tcfg, inputs_embeds, pos, cache, mask,
                                   seq_len=real_len, mrope_ids=mrope, mesh=mesh)
    cache = kv.advance(cache, real_len)
    nxt, key, seen = _draw_token(llama.lm_head(tparams, _take(hidden, real_len - 1), mesh),
                                  sampling, None, seen, key)
    return nxt, cache, key, seen, rope_delta
