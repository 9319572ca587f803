"""The speculative decode loop, greedy path: draft-expand / verify / accept /
commit as one round of device work with no read back to the host.

Every round verifies the drafted tree with the target, walks the tree for
the accepted path, commits the accepted rows to the target cache, appends
them to the draft and grows the next tree.  ``latch_done`` freezes a
finished request on the device, so the host may run rounds ahead of the
counters it reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..models import draft as draft_mod
from ..models import llama
from ..ops import kv_cache as kv
from ..ops.attention import causal_mask
from ..ops.tree import Tree, greedy_accept, path_to_root


def target_forward(tparams, tcfg, embeds, pos, cache, mask, region=None,
                   return_new_kv=False, seq_len=None):
    """The target backbone's forward (dense Llama; Mixtral waits for its slice)."""
    if "router" in tparams["layers"]:
        raise NotImplementedError("MoE targets are not ported yet")
    return llama.forward_hidden(tparams, tcfg, embeds, pos, cache, mask, region,
                                return_new_kv, seq_len=seq_len)


class SpecState(NamedTuple):
    """Device-resident carry between decode rounds."""

    tree: Tree
    target_cache: kv.KVCache
    draft_cache: kv.KVCache
    last_img: torch.Tensor  # [hidden]
    output: torch.Tensor  # [max_out] int32 — tokens generated beyond the prompt
    out_len: torch.Tensor  # [] int32
    new_token: torch.Tensor  # [] int32
    done: torch.Tensor  # [] bool
    fuse_b: torch.Tensor  # [hidden] f32 — folded fuse constant (last_img fixed)


class SamplingParams(NamedTuple):
    """Sampling configuration; only greedy (temperature 0) is ported."""

    temperature: float = 0.0
    top_p: float = 0.0
    top_k: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 1e-5


def _require_greedy(sampling: SamplingParams) -> None:
    if not sampling.greedy:
        raise NotImplementedError(
            "only greedy decoding (temperature 0) is ported; sampling comes later")


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
) -> SpecState:
    """Target prompt prefill, first greedy token, draft prefill + first tree."""
    _require_greedy(sampling)
    pad_len = inputs_embeds.shape[0]
    device = inputs_embeds.device
    real_len = plan.real_len

    position_ids = torch.arange(pad_len, dtype=torch.int32, device=device)
    mask = causal_mask(pad_len, target_cache.max_len, 0, device)
    hidden, target_cache = target_forward(tparams, tcfg, inputs_embeds, position_ids,
                                          target_cache, mask, seq_len=real_len)
    target_cache = kv.advance(target_cache, real_len)
    last_logits = llama.lm_head(tparams, _take(hidden, real_len - 1))
    first_token = torch.argmax(last_logits).to(torch.int32)

    # draft prefill embeds: shifted merged embeds with the sampled token's
    # embedding at slot real_len-1
    shifted = torch.roll(inputs_embeds, -1, dims=0)
    first_embed = _take(dparams["embed"], first_token).to(shifted.dtype)
    rows = torch.arange(pad_len, device=device)
    shifted = torch.where((rows == real_len - 1)[:, None], first_embed[None], shifted)

    last_hidden, last_img, draft_cache = draft_mod.prefill(
        dparams, dcfg, hidden, shifted, plan, draft_cache, max_span)
    w_e, w_h, b_eff = draft_mod.decode_fuse_weights(dparams, dcfg, last_img)
    tree, draft_cache = draft_mod.expand_tree(
        dparams, dcfg, spec, last_hidden, first_token, last_img,
        _rank_head(tparams, dparams), draft_cache, fuse_w=(w_e, w_h, b_eff))

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
    )


# ---------------------------------------------------------------------------
# One decode round
# ---------------------------------------------------------------------------


def _verify_accept_commit(tparams, tcfg, state: SpecState, eos_id, max_new_tokens,
                          max_path: int):
    """Target verify over the tree block, greedy tree walk, KV commit and
    output append.  Returns (hidden [T, D], path, jcols, acc, bonus,
    target_cache, output, out_len, new_token, done)."""
    tree = state.tree
    t = tree.size
    device = tree.tokens.device
    tree_start = state.target_cache.length

    embeds = llama.embed(tparams, tree.tokens)
    pos = tree_start + tree.depth
    hidden, target_cache, new_kv = target_forward(
        tparams, tcfg, embeds, pos, state.target_cache, None,
        region=(tree_start, tree.mask), return_new_kv=True, seq_len=tree_start + t)
    logits = llama.lm_head(tparams, hidden)  # [T, V] float32

    argmax_toks = torch.argmax(logits, dim=-1).to(torch.int32)
    best, acc = greedy_accept(tree, argmax_toks)
    bonus = _take(argmax_toks, best)

    path = path_to_root(tree, best, max_path)
    target_cache = kv.commit_from_blocks(target_cache, tree_start, new_kv[0],
                                         new_kv[1], path, acc + 1)

    committed = tree.tokens[path.to(torch.int64)]  # rows > acc are padding
    jcols = torch.arange(max_path, dtype=torch.int32, device=device)
    valid = jcols <= acc
    eos_hit = torch.any(valid & (committed == eos_id))

    output = state.output.clone()
    kv.write_rows(output, 0, state.out_len, committed)
    out_len = (state.out_len + acc + 1).to(torch.int32)
    new_token = (state.new_token + acc + 1).to(torch.int32)
    done = state.done | eos_hit | (new_token > max_new_tokens)
    return (hidden, path, jcols, acc, bonus, target_cache, output, out_len,
            new_token, done)


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
) -> SpecState:
    """verify -> accept -> commit -> next draft tree, all on the device.
    The caches are written in place; ``state`` must not be used again except
    through what this returns (as the JAX version donates it)."""
    _require_greedy(sampling)
    max_path = spec.depth + 2
    (hidden, path, jcols, acc, bonus, target_cache, output, out_len,
     new_token, done) = _verify_accept_commit(
        tparams, tcfg, state, eos_id, max_new_tokens, max_path)

    tree = state.tree
    path64 = path.to(torch.int64)
    accept_hidden = hidden[path64]  # [max_path, hidden]
    nxt = tree.tokens[path64]
    # row j pairs hidden[path[j]] with token[path[j+1]]; the last valid row
    # (and the padding after it) takes the bonus token
    tok_next = torch.where(jcols < acc, torch.roll(nxt, -1), bonus)

    w_e, w_h = draft_mod.ensure_fuse_mats(dparams, dcfg)
    fuse_w = (w_e, w_h, state.fuse_b)
    seed, draft_cache = draft_mod.append_accepted(
        dparams, dcfg, accept_hidden, tok_next, acc + 1, state.last_img,
        state.draft_cache, fuse_w=fuse_w)
    new_tree, draft_cache = draft_mod.expand_tree(
        dparams, dcfg, spec, seed, bonus, state.last_img,
        _rank_head(tparams, dparams), draft_cache, fuse_w=fuse_w)

    new_state = state._replace(
        tree=new_tree, target_cache=target_cache, draft_cache=draft_cache,
        output=output, out_len=out_len, new_token=new_token, done=done)
    return latch_done(state, new_state)


def latch_done(prev: SpecState, new: SpecState) -> SpecState:
    """Freeze a finished request after an unconditionally executed round:
    the small cursors and the output are selected on ``prev.done``; the big
    K/V buffers are not — rows written past the frozen lengths are
    unreachable and overwritten by the next live round."""

    def sel(old, upd):
        return torch.where(prev.done, old, upd)

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
    )


# ---------------------------------------------------------------------------
# Autoregressive baseline
# ---------------------------------------------------------------------------


def ar_step(
    tparams: dict,
    tcfg: LlamaConfig,
    sampling: SamplingParams,
    token: torch.Tensor,  # [] int32
    cache: kv.KVCache,
):
    """One greedy AR decode step over the same KV runtime; returns
    (next token [] int32, cache)."""
    _require_greedy(sampling)
    embeds = llama.embed(tparams, token.reshape(1))
    pos = cache.length.reshape(1)
    ones = torch.ones((1, 1), dtype=torch.bool, device=token.device)
    hidden, cache = target_forward(tparams, tcfg, embeds, pos, cache, None,
                                   region=(cache.length, ones),
                                   seq_len=cache.length + 1)
    cache = kv.advance(cache, 1)
    nxt = torch.argmax(llama.lm_head(tparams, hidden[0])).to(torch.int32)
    return nxt, cache


def ar_prefill(
    tparams: dict,
    tcfg: LlamaConfig,
    sampling: SamplingParams,
    inputs_embeds: torch.Tensor,  # [pad_len, hidden]
    real_len,
    cache: kv.KVCache,
):
    """Prompt prefill for the AR baseline; returns (first token, cache)."""
    _require_greedy(sampling)
    pad_len = inputs_embeds.shape[0]
    device = inputs_embeds.device
    real_len = torch.as_tensor(real_len, device=device)
    pos = torch.arange(pad_len, dtype=torch.int32, device=device)
    mask = causal_mask(pad_len, cache.max_len, 0, device)
    hidden, cache = target_forward(tparams, tcfg, inputs_embeds, pos, cache, mask,
                                   seq_len=real_len)
    cache = kv.advance(cache, real_len)
    logits = llama.lm_head(tparams, _take(hidden, real_len - 1))
    return torch.argmax(logits).to(torch.int32), cache
