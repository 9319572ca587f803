"""Draft training steps (stage 2 / MTP, stage 1, Medusa heads) under
autograd, with the JAX package's optimizer written out on tensors.

The optimizer is the JAX package's optax chain, not AdamW: gradients are
clipped by value (0.5), scaled by Adam (b1 0.9, b2 0.95, eps 1e-8, no
weight decay), then by a linear warm-up-then-decay learning rate read at
the step count *before* the update (so step 0 runs at lr 0).  Its state is
numpy-portable: a host step count and the first and second moments, one
tensor per parameter (``convert.params.adam_state_from_numpy`` takes
optax's).

A step updates the parameters and the moments in place and returns them,
as the JAX step donates its inputs.  ``bf16=True`` casts the float32
master weights and the batch to bfloat16 for the forward and backward;
logits, losses, gradients on the master weights and the optimizer state
stay float32.  The frozen ``embed`` of a draft gets a zero gradient; the
target's ``head_w`` is an input, never trained.

Under a mesh (``mesh=``, ``parallel/mesh.py``) each rank holds its shard of
the parameters and of Adam's moments (tp: heads, MLP and fuse columns,
``sharding.quantized_draft_specs``), its vocab columns of ``head_w``, and
its part of the batch (``sharding.shard_train_batch``: rows over dp, the
sequence over sp).  Its loss is its rows' term of the global loss, the
gradients of the leaves (replicated over dp and sp) are summed over both,
and the reported loss and metrics are the global ones.  The clip is
elementwise, so the update needs no other collective.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..configs import DraftConfig
from ..models import draft as draft_mod
from ..parallel import sharding
from .losses import draft_loss, smooth_l1, stage1_loss


class TrainBatch(NamedTuple):
    """One device batch (leading batch dim B).

    hidden_states: [B, S, D] target hiddens (noise-augmented upstream)
    embeds:        [B, S, D] vision-merged input embeds
    target:        [B, S, D] next-position target hiddens
    loss_mask:     [B, S]
    plans:         PrefillPlan whose every field has a leading B
    """

    hidden_states: torch.Tensor
    embeds: torch.Tensor
    target: torch.Tensor
    loss_mask: torch.Tensor
    plans: draft_mod.PrefillPlan


def _map(fn, tree):
    """``fn`` over the tensor leaves of nested dicts / NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def leaves(tree: dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of a nested dict's leaves, in key order ("a/b/c")."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out += leaves(v, path + "/")
        else:
            out.append((path, v))
    return out


def _rebuild(tree: dict, values: Dict[str, torch.Tensor], prefix: str = "") -> dict:
    return {k: (_rebuild(v, values, f"{prefix}{k}/") if isinstance(v, dict)
                else values[f"{prefix}{k}"]) for k, v in tree.items()}


def bf16_compute(tree):
    """The mixed-precision compute cast: float32 leaves become bfloat16 for
    the forward and backward products (differentiable: the gradients land
    in float32 on the master leaves); other leaves pass through."""
    return _map(lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x, tree)


# ---------------------------------------------------------------------------
# Optimizer: clip by value -> Adam -> linear warm-up / decay learning rate
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    """``count`` steps taken (the schedule's and Adam's count, a host int);
    ``mu`` / ``nu``: the first and second moments, trees like the params."""

    count: int
    mu: dict
    nu: dict


def _linear(init: float, end: float, steps: int, count: np.float32) -> np.float32:
    """optax.linear_schedule at ``count``, in float32 as optax computes it."""
    if steps <= 0:
        return np.float32(init)
    c = np.float32(min(max(float(count), 0.0), float(steps)))
    frac = np.float32(1.0) - c / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


class Optimizer:
    """The JAX package's ``make_optimizer`` chain: ``optax.clip(grad_clip)``
    -> ``scale_by_adam(b1, b2, eps)`` -> ``scale_by_learning_rate`` of a
    warm-up from 0 to ``lr`` over ``warmup_steps`` joined to a decay to 0
    over ``total_steps - warmup_steps``."""

    def __init__(self, lr: float = 3e-5, warmup_steps: int = 2000,
                 total_steps: int = 800_000, grad_clip: float = 0.5,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.lr, self.warmup_steps, self.total_steps = lr, warmup_steps, total_steps
        self.grad_clip, self.b1, self.b2, self.eps = grad_clip, b1, b2, eps

    def learning_rate(self, count: int) -> float:
        """The rate an update at step ``count`` (0-based) applies."""
        if count < self.warmup_steps:
            return float(_linear(0.0, self.lr, self.warmup_steps, count))
        return float(_linear(self.lr, 0.0, max(self.total_steps - self.warmup_steps, 1),
                             count - self.warmup_steps))

    def init(self, params: dict) -> AdamState:
        return AdamState(0, _map(torch.zeros_like, params), _map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict) -> Tuple[dict, AdamState]:
        """Apply one step in place; a None gradient is a zero one (a frozen
        leaf, which Adam leaves where it is)."""
        lr = self.learning_rate(state.count)
        c = state.count + 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(c))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(c))
        mus, nus = dict(leaves(state.mu)), dict(leaves(state.nu))
        for path, p in leaves(params):
            g = _get(grads, path)
            mu, nu = mus[path], nus[path]
            if g is None:
                mu.mul_(self.b1)
                nu.mul_(self.b2)
            else:
                g = torch.clamp(g.to(mu.dtype), -self.grad_clip, self.grad_clip)
                mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_((upd * -lr).to(p.dtype))
        return params, AdamState(c, state.mu, state.nu)


def _get(tree: dict, path: str):
    node = tree
    for k in path.split("/"):
        if node is None:
            return None
        node = node.get(k)
    return node


def make_optimizer(lr: float = 3e-5, warmup_steps: int = 2000, total_steps: int = 800_000,
                   grad_clip: float = 0.5) -> Optimizer:
    return Optimizer(lr, warmup_steps, total_steps, grad_clip)


# ---------------------------------------------------------------------------
# Forwards and steps
# ---------------------------------------------------------------------------


def plan_at(plans: draft_mod.PrefillPlan, b: int) -> draft_mod.PrefillPlan:
    """Example ``b``'s plan of a batched one."""
    return draft_mod.PrefillPlan(*(f[b] for f in plans))


def _forward_batch(p, dcfg, hidden, embeds, plans, max_span, mesh=None):
    """``forward_train`` of every example (the JAX step's ``vmap``)."""
    return torch.stack([draft_mod.forward_train(p, dcfg, hidden[b], embeds[b],
                                                plan_at(plans, b), max_span, mesh)
                        for b in range(hidden.shape[0])])


def mtp_forward(
    dparams: dict,
    dcfg: DraftConfig,
    head_w: torch.Tensor,  # [D, V] frozen target lm_head
    batch: TrainBatch,
    mtp_steps: int,
    max_span: int,
    mesh=None,
) -> Tuple[torch.Tensor, dict]:
    """Stacked multi-token-prediction forward and loss: step m feeds step
    m-1's predictions (shifted one right, the first hidden kept) back in.
    Under sp the shift crosses the ranks' boundaries: the predictions are
    gathered over sp, shifted, and each rank keeps its rows."""
    predict = _forward_batch(dparams, dcfg, batch.hidden_states, batch.embeds,
                             batch.plans, max_span, mesh)
    predicts = [predict]
    cur = predict
    first = sharding.broadcast(batch.hidden_states[:, :1], mesh, "sp", 0)
    for _ in range(mtp_steps):
        whole = sharding.gather_seq(cur, mesh, dim=1)
        cur = torch.cat([first, whole[:, :-1]], dim=1)[:, sharding.seq_rows(
            mesh, whole.shape[1])]
        cur = _forward_batch(dparams, dcfg, cur, batch.embeds, batch.plans, max_span, mesh)
        predicts.append(cur)
    stacked = torch.cat(predicts, dim=0)  # [(m+1)*B, S, D]

    n = mtp_steps + 1
    with torch.no_grad():
        target_p = torch.softmax(sharding.vocab_logits(batch.target, head_w, mesh),
                                 dim=-1).repeat(n, 1, 1)
    mask = batch.loss_mask.repeat(n, 1)
    student_logits = sharding.vocab_logits(stacked, head_w, mesh)
    return draft_loss(student_logits, target_p, mask, mesh=mesh)


def _grad_step(params: dict, frozen: Tuple[str, ...], loss_fn, opt_state, optimizer,
               mesh=None):
    """Gradients of ``loss_fn(p)`` for every leaf but ``frozen`` ones (summed
    over dp and sp under a mesh), then the optimizer's in-place update.
    Returns (params, state, metrics with ``loss``), the metrics as device
    scalars (global under a mesh)."""
    live = {path: t.detach().requires_grad_(True) for path, t in leaves(params)
            if path not in frozen}
    values = {path: live.get(path, t) for path, t in leaves(params)}
    with torch.enable_grad():
        loss, metrics = loss_fn(_rebuild(params, values))
        grads = torch.autograd.grad(loss, list(live.values()))
    by_path = dict(zip(live, sharding.sum_grads(grads, mesh)))
    gtree = _rebuild(params, {path: by_path.get(path) for path, _ in leaves(params)})
    params, opt_state = optimizer.update(gtree, opt_state, params)
    metrics = dict(metrics, loss=loss)
    reported = sharding.sum_over_data(torch.stack([v.detach() for v in metrics.values()]),
                                      mesh)
    return params, opt_state, dict(zip(metrics, reported.unbind(0)))


def _compute_cast(bf16: bool, *trees):
    return tuple(bf16_compute(t) for t in trees) if bf16 else trees


def train_step(
    dparams: dict,
    opt_state: AdamState,
    dcfg: DraftConfig,
    head_w: torch.Tensor,
    batch: TrainBatch,
    optimizer: Optimizer,
    mtp_steps: int = 2,
    max_span: int = 1,
    bf16: bool = False,
    mesh=None,
):
    """One stage-2 (MTP) optimization step; ``embed`` stays frozen."""

    def loss_fn(p):
        p, b, hw = _compute_cast(bf16, p, batch, head_w)
        return mtp_forward(p, dcfg, hw, b, mtp_steps, max_span, mesh)

    return _grad_step(dparams, ("embed",), loss_fn, opt_state, optimizer, mesh)


def train_step_stage1(
    dparams: dict,
    opt_state: AdamState,
    dcfg: DraftConfig,
    head_w: torch.Tensor,
    batch: TrainBatch,
    optimizer: Optimizer,
    v_w: float = 1.0,
    p_w: float = 0.1,
    max_span: int = 1,
    bf16: bool = False,
    mesh=None,
):
    """Stage-1 text-only distillation step: SmoothL1 on predicted hidden
    states + soft cross-entropy + ranking loss."""

    def loss_fn(p):
        p, b, hw = _compute_cast(bf16, p, batch, head_w)
        predict = _forward_batch(p, dcfg, b.hidden_states, b.embeds, b.plans, max_span,
                                 mesh)
        student_logits = sharding.vocab_logits(predict, hw, mesh)
        with torch.no_grad():
            target_p = torch.softmax(sharding.vocab_logits(b.target, hw, mesh), dim=-1)
        return stage1_loss(
            predict.reshape(-1, predict.shape[-1]),
            b.target.reshape(-1, b.target.shape[-1]),
            student_logits.reshape(-1, student_logits.shape[-1]),
            target_p.reshape(-1, target_p.shape[-1]),
            batch.loss_mask.reshape(-1), v_w=v_w, p_w=p_w, mesh=mesh)

    return _grad_step(dparams, ("embed",), loss_fn, opt_state, optimizer, mesh)


def train_step_medusa(
    mparams: dict,
    opt_state: AdamState,
    head_w: torch.Tensor,
    batch: TrainBatch,
    optimizer: Optimizer,
    v_w: float = 1.0,
    p_w: float = 0.1,
    bf16: bool = False,
    mesh=None,
):
    """Medusa heads training: head i's target is the target hidden with its
    first i positions zeroed; loss = v_w * SmoothL1(hidden) + p_w * soft-CE,
    summed over heads.  The heads are replicated under a mesh; only the
    batch splits."""
    from ..models.medusa import NUM_HEADS, heads_forward

    def loss_fn(p):
        p, b, hw = _compute_cast(bf16, p, batch, head_w)
        predict = heads_forward(p, b.hidden_states)  # [H, B, S, D]
        rows = b.target.shape[1]  # this rank's sequence rows: global pos from start
        start = sharding.seq_rows(mesh, rows * sharding.axis_size(mesh, "sp")).start
        pos = torch.arange(start, start + rows, device=b.target.device)[None, :, None]
        tgt = torch.stack([torch.where(pos >= i, b.target, torch.zeros_like(b.target))
                           for i in range(NUM_HEADS)])
        mask = batch.loss_mask[None].float()  # [1, B, S]
        denom = torch.clamp_min(sharding.sum_over_data(mask.sum(), mesh) * NUM_HEADS, 1.0)
        vloss = (smooth_l1(predict.float(), tgt.float()).mean(-1) * mask).sum() / denom
        s_logits = sharding.vocab_logits(predict, hw, mesh)
        with torch.no_grad():
            t_p = torch.softmax(sharding.vocab_logits(tgt, hw, mesh), dim=-1)
        ploss = -((t_p * torch.log_softmax(s_logits, dim=-1)).sum(-1) * mask).sum() / denom
        loss = v_w * vloss + p_w * ploss
        hit = (torch.argmax(s_logits.detach(), -1) == torch.argmax(t_p, -1)).float()
        return loss, {"vloss": vloss, "ploss": ploss, "acc": (hit * mask).sum() / denom}

    return _grad_step(mparams, (), loss_fn, opt_state, optimizer, mesh)
