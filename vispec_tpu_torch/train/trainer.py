"""Stage-2 (multimodal MTP) draft trainer.

A dataset of ``{hidden_state, inputs_embeds, loss_mask, image_mask}``
records (``train/data_gen.py``), uniform noise on the hidden states
(``noise_std`` 0.2), a per-sample crop to ``max_len`` with the
one-position target shift, the MTP recursion (``train/step.py``), per-epoch
checkpoints with auto-resume from the newest, and ``getkacc``, the k-step
draft rollout accuracy on held-out data.

The dataset pipeline is numpy on the host, one loader thread ahead of the
device step; each example's compression plan is the inference
``PrefillPlan``.  The noise comes from a seeded numpy generator, as in the
JAX package, so both trainers see the same batches.  Checkpoints pickle
numpy only (params, Adam's ``count`` / ``mu`` / ``nu``, the epoch) under
the JAX package's file names; the JAX package's own pickles hold optax
classes, which this package does not read.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..configs import DraftConfig
from ..models import draft as draft_mod
from ..ops.kv_cache import init_cache
from ..ops.quant import qdot
from .step import AdamState, TrainBatch, make_optimizer, train_step

# parallel training (ROADMAP item 21b) has no counterpart yet
_NO_MESH = ("a device mesh is not in the PyTorch port's training yet (ROADMAP Queue 1 "
            "item 21b, parallel training); train on one device")


@dataclass
class TrainConfig:
    lr: float = 3e-5
    bs: int = 1  # examples a step
    num_epochs: int = 20
    max_len: int = 1024
    noise_std: float = 0.2  # uniform noise on hidden states
    mtp_steps: int = 2
    grad_clip: float = 0.5
    warmup_steps: int = 2000
    total_steps: int = 800_000
    max_images: int = 4
    max_span_bucket: int = 64
    save_freq: int = 1  # epochs
    bf16: bool = False  # bf16 products, f32 master weights, losses and state
    ckpt_backend: str = "pickle"  # "pickle" only ("orbax" waits for item 21b)


def prepare_example(
    sample: Dict[str, np.ndarray],
    cfg: TrainConfig,
    dcfg: DraftConfig,
    rng: np.random.Generator,
) -> Optional[Tuple[dict, draft_mod.PrefillPlan, int]]:
    """Crop, shift, noise.  Draft input at position i pairs hidden_state[i]
    with the NEXT token's embedding; the target is hidden_state[i+1].
    Returns (numpy arrays padded to ``max_len``, the plan on the CPU, the
    plan's span bucket), or None for a sample shorter than 3."""
    s = sample["hidden_state"].shape[0]
    if s < 3:
        return None
    s = min(s, cfg.max_len)
    hidden = sample["hidden_state"][:s].astype(np.float32)
    embeds = sample["inputs_embeds"][:s].astype(np.float32)
    loss_mask = sample["loss_mask"][:s].astype(np.float32)
    image_mask = sample["image_mask"][:s].astype(bool)

    h_in = hidden[:-1]
    e_in = embeds[1:]
    target = hidden[1:]
    mask = loss_mask[1:]
    img = image_mask[1:]

    noise = rng.uniform(-cfg.noise_std, cfg.noise_std, h_in.shape).astype(np.float32)
    h_in = h_in + noise

    pad_len = cfg.max_len
    seq = h_in.shape[0]
    plan, max_span = draft_mod.make_prefill_plan(
        img, seq, dcfg.num_q, pad_len, max_images=cfg.max_images,
        max_span=cfg.max_span_bucket, device="cpu")

    def pad(x):
        return np.pad(x, [(0, pad_len - seq)] + [(0, 0)] * (x.ndim - 1))

    ex = {
        "hidden_states": pad(h_in),
        "embeds": pad(e_in),
        "target": pad(target),
        "loss_mask": pad(mask),
    }
    return ex, plan, max_span


def batch_examples(examples: List[Tuple[dict, draft_mod.PrefillPlan, int]],
                   device="cuda") -> Tuple[TrainBatch, int]:
    """Stack prepared examples into one batch on ``device``; returns it and
    the largest span bucket."""
    max_span = max(e[2] for e in examples)
    arrs = {k: torch.from_numpy(np.stack([e[0][k] for e in examples])).to(device)
            for k in examples[0][0]}
    plans = draft_mod.PrefillPlan(*(torch.stack(fs).to(device)
                                    for fs in zip(*[e[1] for e in examples])))
    return (TrainBatch(hidden_states=arrs["hidden_states"], embeds=arrs["embeds"],
                       target=arrs["target"], loss_mask=arrs["loss_mask"], plans=plans),
            max_span)


def data_iterator(
    datadir: str, cfg: TrainConfig, dcfg: DraftConfig, seed: int = 0,
    prefetch: int = 2, device="cuda",
) -> Iterator[Tuple[TrainBatch, int]]:
    """Shuffled batches of prepared examples.  ``prefetch`` > 0 runs the
    npz load and the crop / shift / noise on a background thread, that many
    batches ahead of the device step."""
    it = _data_iterator_sync(datadir, cfg, dcfg, seed, device)
    if prefetch <= 0:
        yield from it
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # raised in the consumer: an epoch is
            q.put(e)                # never cut short without a word

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def _data_iterator_sync(
    datadir: str, cfg: TrainConfig, dcfg: DraftConfig, seed: int = 0, device="cuda",
) -> Iterator[Tuple[TrainBatch, int]]:
    from .data_gen import load_sample

    files = sorted(glob.glob(os.path.join(datadir, "data_*.npz")))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(files))
    batch: List = []
    for i in order:
        try:
            ex = prepare_example(load_sample(files[i]), cfg, dcfg, rng)
        except Exception:
            continue
        if ex is None:
            continue
        batch.append(ex)
        if len(batch) == cfg.bs:
            yield batch_examples(batch, device)
            batch = []


# ---------------------------------------------------------------------------
# getkacc: k-step draft rollout accuracy
# ---------------------------------------------------------------------------


@torch.no_grad()
def getkacc(
    dparams: dict,
    dcfg: DraftConfig,
    head_w: torch.Tensor,
    sample: Dict[str, np.ndarray],
    max_length: int = 5,
    max_prefixes: int = 16,
    max_len: int = 512,
    max_span: int = 64,
) -> List[float]:
    """For sampled prefix lengths, roll the draft k steps and score each
    step's argmax against the target hidden's argmax.  Every prefix rides
    one batched rollout (``_kacc_rollout_batched``)."""
    device = head_w.device
    s = min(sample["hidden_state"].shape[0], max_len)
    hidden = torch.as_tensor(np.asarray(sample["hidden_state"][:s], np.float32),
                             device=device)
    embeds = torch.as_tensor(np.asarray(sample["inputs_embeds"][:s], np.float32),
                             device=device)
    loss_mask = sample["loss_mask"][:s]
    image_mask = sample["image_mask"][:s]
    target_ids = torch.argmax(qdot(hidden, head_w), dim=-1).cpu().numpy()

    candidates = [p for p in range(2, s - max_length) if loss_mask[p] > 0]
    if not candidates:
        return [0.0] * max_length
    rng = np.random.default_rng(0)
    prefixes = rng.choice(candidates, min(max_prefixes, len(candidates)), replace=False)

    total = np.zeros(max_length)
    correct = np.zeros(max_length)
    # P pads to max_prefixes (the last prefix repeated; the host scoring
    # drops the padding); steps past a mismatch are computed and discarded
    pref_list = [int(p) for p in prefixes]
    padded = pref_list + [pref_list[-1]] * (max_prefixes - len(pref_list))
    plans, h_pads, e_pads = [], [], []
    ms_all = 1
    for pre_len in padded:
        plan, ms = draft_mod.make_prefill_plan(
            image_mask[1:pre_len], pre_len - 1, dcfg.num_q, max_len,
            max_images=8, max_span=max_span, device=device)
        ms_all = max(ms_all, ms)
        plans.append(plan)
        h_pads.append(_pad_rows(hidden[: pre_len - 1], max_len))
        e_pads.append(_pad_rows(embeds[1:pre_len], max_len))
    toks_all = _kacc_rollout_batched(
        dparams, dcfg, head_w, torch.stack(h_pads), torch.stack(e_pads),
        draft_mod.PrefillPlan(*(torch.stack(fs) for fs in zip(*plans))),
        max_len + max_length + 2, max_length, ms_all)
    toks_host = toks_all.cpu().numpy()[: len(pref_list)]

    for pre_len, toks in zip(pref_list, toks_host):
        ok = True
        for k in range(max_length):
            if pre_len + k >= s or loss_mask[pre_len + k] == 0:
                break
            total[k] += 1
            if ok and int(toks[k]) == int(target_ids[pre_len + k - 1]):
                correct[k] += 1
            else:
                ok = False
                for kk in range(k + 1, max_length):
                    if pre_len + kk < s and loss_mask[pre_len + kk] > 0:
                        total[kk] += 1
                break
    return [float(correct[i] / total[i]) if total[i] else 0.0 for i in range(max_length)]


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((rows - x.shape[0], x.shape[1]))])


def _kacc_rollout_one(dparams, dcfg, head_w, h_pad, e_pad, plan, cache_rows: int,
                      k: int, max_span: int) -> torch.Tensor:
    """One prefix: draft prefill + k greedy feed-back steps; the k predicted
    token ids (the oracle of the batched rollout)."""
    cache = draft_mod.init_draft_cache(dcfg, cache_rows, torch.float32, h_pad.device)
    cur, last_img, cache = draft_mod.prefill(dparams, dcfg, h_pad, e_pad, plan, cache,
                                             max_span)
    one = torch.ones((), dtype=torch.int32, device=h_pad.device)
    toks = []
    for _ in range(k):
        tok = torch.argmax(qdot(cur, head_w)).to(torch.int32)
        cur, cache = draft_mod.append_accepted(dparams, dcfg, cur[None], tok[None], one,
                                               last_img, cache)
        toks.append(tok)
    return torch.stack(toks)


def _kacc_rollout_batched(dparams, dcfg, head_w, h_pads, e_pads, plans, cache_rows: int,
                          k: int, max_span: int) -> torch.Tensor:
    """All P prefix rollouts: each prefix's prefill writes into its slot of
    a slot-stacked float32 cache, then k steps append all P prefixes'
    tokens in one batched call each (the batched verify kernel on the card),
    so the draft layer and the head stream once a step for every prefix.
    Returns [P, k] token ids."""
    from ..spec.batch import _slot_cache

    p_count, device = h_pads.shape[0], h_pads.device
    cache = init_cache(1, dcfg.num_key_value_heads, cache_rows, dcfg.head_dim,
                       torch.float32, device, slots=p_count)
    firsts = [draft_mod.prefill(dparams, dcfg, h_pads[i], e_pads[i],
                                draft_mod.PrefillPlan(*(f[i] for f in plans)),
                                _slot_cache(cache, i), max_span)
              for i in range(p_count)]
    cur = torch.stack([f[0] for f in firsts])
    last_img = torch.stack([f[1] for f in firsts])
    cache = cache._replace(length=torch.stack([f[2].length for f in firsts]),
                           real_length=torch.stack([f[2].real_length for f in firsts]))
    ones = torch.ones((p_count,), dtype=torch.int32, device=device)
    toks = []
    for _ in range(k):
        tok = torch.argmax(qdot(cur, head_w), dim=-1).to(torch.int32)
        cur, cache = draft_mod.append_accepted(dparams, dcfg, cur[:, None], tok[:, None],
                                               ones, last_img, cache)
        toks.append(tok)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# Checkpointing (auto-resume)
# ---------------------------------------------------------------------------


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy())
            for k, v in tree.items()}


def _check_backend(backend: str) -> None:
    if backend != "pickle":
        raise NotImplementedError(
            f"ckpt_backend={backend!r}: a sharded checkpoint backend waits for parallel "
            "training (ROADMAP Queue 1 item 21b); use 'pickle'")


def save_state(cpdir: str, epoch: int, dparams: dict, opt_state: AdamState,
               backend: str = "pickle") -> str:
    """``{cpdir}/state_{epoch}.pkl``: the params and Adam's state as numpy."""
    _check_backend(backend)
    os.makedirs(cpdir, exist_ok=True)
    path = os.path.join(cpdir, f"state_{epoch}.pkl")
    with open(path, "wb") as f:
        pickle.dump({
            "epoch": epoch,
            "params": _numpy_tree(dparams),
            "opt_state": {"count": np.asarray(opt_state.count, np.int32),
                          "mu": _numpy_tree(opt_state.mu),
                          "nu": _numpy_tree(opt_state.nu)},
        }, f)
    return path


def latest_state(cpdir: str) -> Optional[str]:
    states = glob.glob(os.path.join(cpdir, "state_*.pkl"))
    if not states:
        return None
    return max(states, key=lambda p: int(re.search(r"state_(\d+)", p).group(1)))


def load_state(path: str, template=None, device="cuda"):
    """(epoch, params, AdamState) of a checkpoint, the tensors on
    ``device``; ``template`` is accepted for the JAX signature and unused
    (the pickle holds its own structure)."""
    from ..convert.params import adam_state_from_numpy, from_numpy

    del template
    if path.endswith(".orbax"):
        _check_backend("orbax")
    with open(path, "rb") as f:
        blob = pickle.load(f)
    opt = blob["opt_state"]
    return (blob["epoch"], from_numpy(blob["params"], device),
            adam_state_from_numpy(opt["count"], opt["mu"], opt["nu"], device))


def train(
    datadir: str,
    cpdir: str,
    dcfg: DraftConfig,
    head_w: torch.Tensor,
    cfg: TrainConfig = TrainConfig(),
    dparams: Optional[dict] = None,
    log_every: int = 20,
    stage1: bool = False,
    mesh=None,
) -> dict:
    """The training loop with auto-resume from the newest ``state_*.pkl``
    in ``cpdir``; returns the final draft params (float32, on
    ``head_w``'s device).  A fresh run without ``dparams`` starts from
    ``draft.init_params`` of seed 0."""
    from .step import train_step_stage1

    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    _check_backend(cfg.ckpt_backend)
    device = head_w.device
    optimizer = make_optimizer(cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.grad_clip)
    begin_epoch = 0
    resume = latest_state(cpdir)
    if resume is not None:
        begin_epoch, dparams, opt_state = load_state(resume, device=device)
        begin_epoch += 1
        print(f"[train] resumed from {resume} (epoch {begin_epoch})")
    else:
        if dparams is None:
            gen = torch.Generator(device=device).manual_seed(0)
            dparams = draft_mod.init_params(dcfg, gen, device, torch.float32)
        opt_state = optimizer.init(dparams)

    # metrics stream: one JSON line of scalars every log_every steps
    os.makedirs(cpdir, exist_ok=True)
    metrics_path = os.path.join(cpdir, "metrics.jsonl")

    step = 0
    for epoch in range(begin_epoch, cfg.num_epochs):
        with open(metrics_path, "a") as mf:
            for batch, _ in data_iterator(datadir, cfg, dcfg, seed=epoch, device=device):
                if stage1:
                    dparams, opt_state, metrics = train_step_stage1(
                        dparams, opt_state, dcfg, head_w, batch, optimizer,
                        max_span=cfg.max_span_bucket, bf16=cfg.bf16)
                else:
                    dparams, opt_state, metrics = train_step(
                        dparams, opt_state, dcfg, head_w, batch, optimizer,
                        mtp_steps=cfg.mtp_steps, max_span=cfg.max_span_bucket,
                        bf16=cfg.bf16)
                if step % log_every == 0:
                    scalars = {k: float(v) for k, v in metrics.items()}
                    scalars.update(epoch=epoch, step=step)
                    mf.write(json.dumps(scalars) + "\n")
                    mf.flush()
                    print(f"[train] epoch {epoch} step {step} "
                          f"loss={scalars['loss']:.4f} acc={scalars['acc']:.4f}")
                step += 1

            # per-epoch k-step rollout accuracy
            eval_files = sorted(glob.glob(os.path.join(datadir, "data_*.npz")))[:2]
            if eval_files:
                from .data_gen import load_sample

                accs = getkacc(dparams, dcfg, head_w, load_sample(eval_files[0]),
                               max_length=3, max_prefixes=4, max_len=cfg.max_len,
                               max_span=cfg.max_span_bucket)
                mf.write(json.dumps({"epoch": epoch, "getkacc": accs}) + "\n")
                print(f"[train] epoch {epoch} getkacc={accs}")
        if (epoch + 1) % cfg.save_freq == 0 or epoch == cfg.num_epochs - 1:
            save_state(cpdir, epoch, dparams, opt_state, backend=cfg.ckpt_backend)
    return dparams
