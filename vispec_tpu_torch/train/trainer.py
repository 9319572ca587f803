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
JAX package, so both trainers see the same batches.

``train(mesh=...)`` runs one process per rank (``torchrun``): every rank
builds the same global batch from the epoch's seed and keeps its part
(``sharding.shard_train_batch``), holds its shard of the draft and of
Adam's moments (``sharding.quantized_draft_specs``) and its vocab columns
of the frozen head, and rank 0 alone writes ``metrics.jsonl``.

Two checkpoint backends, under the JAX package's names and file names:
``"pickle"`` writes ``state_{epoch}.pkl``, numpy only (params, Adam's
``count`` / ``mu`` / ``nu``, the epoch), gathered to rank 0 under a mesh;
``"orbax"`` writes the directory ``state_{epoch}.orbax`` in the format of
``torch.distributed.checkpoint``, each rank its own shards with no gather
(a quantized leaf field by field).  Neither reads the JAX package's files
(optax classes in its pickles, orbax's format in its directories), nor does
the JAX package read these.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re
import warnings
from dataclasses import dataclass, fields
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..configs import DraftConfig
from ..models import draft as draft_mod
from ..ops.kv_cache import init_cache
from ..ops.quant import Q4Tensor, QTensor
from ..parallel import sharding
from .step import AdamState, TrainBatch, make_optimizer, train_step


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
    ckpt_backend: str = "pickle"  # "pickle" (one file) or "orbax" (a directory of
    # torch.distributed.checkpoint shards, written by every rank)


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
    mesh=None,
) -> List[float]:
    """For sampled prefix lengths, roll the draft k steps and score each
    step's argmax against the target hidden's argmax.  Every prefix rides
    one batched rollout (``_kacc_rollout_batched``).  Under a mesh the
    draft and the head are this rank's tp shards (the draft's decode
    forwards at the rank's heads, the logits gathered over tp), and every
    rank returns the same scores."""
    device = head_w.device
    s = min(sample["hidden_state"].shape[0], max_len)
    hidden = torch.as_tensor(np.asarray(sample["hidden_state"][:s], np.float32),
                             device=device)
    embeds = torch.as_tensor(np.asarray(sample["inputs_embeds"][:s], np.float32),
                             device=device)
    loss_mask = sample["loss_mask"][:s]
    image_mask = sample["image_mask"][:s]
    target_ids = torch.argmax(sharding.vocab_logits(hidden, head_w, mesh), dim=-1).cpu().numpy()

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
        max_len + max_length + 2, max_length, ms_all, mesh)
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
                      k: int, max_span: int, mesh=None) -> torch.Tensor:
    """One prefix: draft prefill + k greedy feed-back steps; the k predicted
    token ids (the oracle of the batched rollout)."""
    heads = sharding.local_cache_dims(mesh, 1, dcfg.num_key_value_heads)[1]
    cache = init_cache(1, heads, cache_rows, dcfg.head_dim, torch.float32, h_pad.device)
    cur, last_img, cache = draft_mod.prefill(dparams, dcfg, h_pad, e_pad, plan, cache,
                                             max_span, mesh)
    one = torch.ones((), dtype=torch.int32, device=h_pad.device)
    toks = []
    for _ in range(k):
        tok = torch.argmax(sharding.vocab_logits(cur, head_w, mesh)).to(torch.int32)
        cur, cache = draft_mod.append_accepted(dparams, dcfg, cur[None], tok[None], one,
                                               last_img, cache, mesh=mesh)
        toks.append(tok)
    return torch.stack(toks)


def _kacc_rollout_batched(dparams, dcfg, head_w, h_pads, e_pads, plans, cache_rows: int,
                          k: int, max_span: int, mesh=None) -> torch.Tensor:
    """All P prefix rollouts: each prefix's prefill writes into its slot of
    a slot-stacked float32 cache, then k steps append all P prefixes'
    tokens in one batched call each (the batched verify kernel on the card),
    so the draft layer and the head stream once a step for every prefix.
    Returns [P, k] token ids."""
    from ..spec.batch import _slot_cache

    p_count, device = h_pads.shape[0], h_pads.device
    heads = sharding.local_cache_dims(mesh, 1, dcfg.num_key_value_heads)[1]
    cache = init_cache(1, heads, cache_rows, dcfg.head_dim, torch.float32, device,
                       slots=p_count)
    firsts = [draft_mod.prefill(dparams, dcfg, h_pads[i], e_pads[i],
                                draft_mod.PrefillPlan(*(f[i] for f in plans)),
                                _slot_cache(cache, i), max_span, mesh)
              for i in range(p_count)]
    cur = torch.stack([f[0] for f in firsts])
    last_img = torch.stack([f[1] for f in firsts])
    cache = cache._replace(length=torch.stack([f[2].length for f in firsts]),
                           real_length=torch.stack([f[2].real_length for f in firsts]))
    ones = torch.ones((p_count,), dtype=torch.int32, device=device)
    toks = []
    for _ in range(k):
        tok = torch.argmax(sharding.vocab_logits(cur, head_w, mesh), dim=-1).to(torch.int32)
        cur, cache = draft_mod.append_accepted(dparams, dcfg, cur[:, None], tok[:, None],
                                               ones, last_img, cache, mesh=mesh)
        toks.append(tok)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# Checkpointing (auto-resume)
# ---------------------------------------------------------------------------


def _items(tree: dict, prefix: str = ""):
    """(path, tensor) of a parameter tree's tensors, a quantized leaf's
    fields as ``path:field``."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _items(v, path + "/")
        elif isinstance(v, (QTensor, Q4Tensor)):
            for f in fields(v):
                yield f"{path}:{f.name}", getattr(v, f.name)
        else:
            yield path, v


def _from_items(items: Dict[str, torch.Tensor]) -> dict:
    """``_items``' inverse."""
    tree: dict = {}
    quant: Dict[str, dict] = {}
    for path, t in items.items():
        base, _, field_name = path.partition(":")
        *parents, leaf = base.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        if field_name:
            quant.setdefault(base, {})[field_name] = t
            node[leaf] = None
        else:
            node[leaf] = t
    for base, flds in quant.items():
        *parents, leaf = base.split("/")
        node = tree
        for k in parents:
            node = node[k]
        node[leaf] = (Q4Tensor if "packed" in flds else QTensor)(**flds)
    return tree


def _spec_at(specs: Optional[dict], path: str):
    """The split spec of ``_items``' ``path`` (None: whole)."""
    if specs is None:
        return None
    base, _, field_name = path.partition(":")
    node = specs
    for k in base.split("/"):
        node = node[k]
    return getattr(node, field_name) if field_name else node


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy())
            for k, v in tree.items()}


def _check_backend(backend: str) -> None:
    if backend not in ("pickle", "orbax"):
        raise ValueError(f"ckpt_backend={backend!r}: 'pickle' or 'orbax'")


# a tensor's key in a state_{epoch}.orbax directory: section/path@i of n, the
# dim the n pieces split (params, mu and nu pieces of one leaf split alike)
_DCP_KEY = re.compile(r"^(\w+)/(.+)@(\d+)of(\d+)d(\d+)$")


def _save_dcp(path: str, sections: Dict[str, dict], count: int, mesh, specs) -> None:
    import torch.distributed.checkpoint as dcp

    sd = {"opt/count@0of1d0": torch.tensor(count, dtype=torch.int64)}
    tp = sharding.axis_size(mesh, "tp")
    for name, tree in sections.items():
        for leaf, t in _items(tree):
            spec = _spec_at(specs, leaf)
            dim = None if spec is None or tp == 1 else sharding.split_dim(spec)
            i, n = (0, 1) if dim is None else (mesh.coords["tp"], tp)
            # pieces of one leaf on ranks that differ in dp or sp alone are
            # equal: the planner writes each key once
            sd[f"{name}/{leaf}@{i}of{n}d{dim or 0}"] = t.detach().contiguous()
    with warnings.catch_warnings():  # DCP's note that no_dist means one process
        warnings.simplefilter("ignore", UserWarning)
        dcp.save(sd, checkpoint_id=path, no_dist=mesh is None)


def _load_dcp(path: str, names, device, mesh, specs) -> Dict[str, dict]:
    """The ``names`` sections of a DCP state directory: whole leaves, or
    this rank's shards under ``mesh``.  A leaf saved in as many pieces as
    the mesh's tp loads only this rank's piece; any other leaf loads whole
    (its pieces joined) and, where ``specs`` split it, is cut (a save at
    another tp, or whole)."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    leaves: Dict[tuple, dict] = {}
    for key in meta:
        hit = _DCP_KEY.match(key)
        if hit and hit.group(1) in names:
            name, leaf, i, n, dim = hit.groups()
            leaves.setdefault((name, leaf), {"n": int(n), "dim": int(dim), "keys": {}})[
                "keys"][int(i)] = key
    tp = sharding.axis_size(mesh, "tp")
    plan, sd = {}, {}
    for (name, leaf), info in leaves.items():
        cut = None
        if tp > 1 and info["n"] == tp:
            wanted = [info["keys"][mesh.coords["tp"]]]
        else:
            wanted = [info["keys"][i] for i in range(info["n"])]
            spec = _spec_at(specs, leaf) if tp > 1 and name != "opt" else None
            if spec is not None and sharding.split_dim(spec) is not None:
                cut = spec
        for key in wanted:
            sd[key] = torch.empty(tuple(meta[key].size), dtype=meta[key].properties.dtype,
                                  device=device)
        plan[(name, leaf)] = (wanted, info["dim"], cut)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(sd, checkpoint_id=path, no_dist=mesh is None)
    out: Dict[str, dict] = {name: {} for name in names}
    for (name, leaf), (wanted, dim, cut) in plan.items():
        t = sd[wanted[0]] if len(wanted) == 1 else torch.cat([sd[k] for k in wanted], dim)
        if cut is not None:
            t = sharding.local_part(t, cut, mesh.shape, mesh.coords).contiguous()
        out[name][leaf] = t
    return {name: _from_items(items) for name, items in out.items()}


def save_state(cpdir: str, epoch: int, dparams: dict, opt_state: AdamState,
               backend: str = "pickle", mesh=None, specs: Optional[dict] = None) -> str:
    """Write ``{cpdir}/state_{epoch}.pkl`` (``backend="pickle"``: numpy only)
    or the directory ``{cpdir}/state_{epoch}.orbax`` (``"orbax"``: the
    format of ``torch.distributed.checkpoint``); returns the path.  Under a
    mesh every rank calls it with its shards and ``specs``, their split
    (``sharding.quantized_draft_specs``; None: every leaf whole on every
    rank): the pickle gathers them and rank 0 writes it; each rank writes
    its own shards of the directory."""
    _check_backend(backend)
    if specs is None and sharding.axis_size(mesh, "tp") > 1:
        raise ValueError("save_state under a tp mesh needs the params' specs")
    os.makedirs(cpdir, exist_ok=True)
    if backend == "orbax":
        path = os.path.abspath(os.path.join(cpdir, f"state_{epoch}.orbax"))
        _save_dcp(path, {"params": dparams, "mu": opt_state.mu, "nu": opt_state.nu},
                  opt_state.count, mesh, specs)
        return path
    path = os.path.join(cpdir, f"state_{epoch}.pkl")
    whole = [sharding.gather_params(mesh, t, specs)
             for t in (dparams, opt_state.mu, opt_state.nu)]
    if mesh is None or mesh.rank == 0:
        with open(path, "wb") as f:
            pickle.dump({
                "epoch": epoch,
                "params": _numpy_tree(whole[0]),
                "opt_state": {"count": np.asarray(opt_state.count, np.int32),
                              "mu": _numpy_tree(whole[1]),
                              "nu": _numpy_tree(whole[2])},
            }, f)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()  # the file is whole before any rank looks for it
    return path


def latest_state(cpdir: str) -> Optional[str]:
    """The newest ``state_{epoch}.pkl`` or ``state_{epoch}.orbax`` in
    ``cpdir``, or None."""
    states = glob.glob(os.path.join(cpdir, "state_*.pkl")) + glob.glob(
        os.path.join(cpdir, "state_*.orbax"))
    return max(states, key=_epoch_of) if states else None


def _epoch_of(path: str) -> int:
    return int(re.search(r"state_(\d+)", path).group(1))


def _place(tree: dict, device, mesh, specs) -> dict:
    from ..convert.params import from_numpy

    tree = from_numpy(tree, device)
    return tree if mesh is None or specs is None else sharding.apply_specs(mesh, tree, specs)


def load_params(path: str, device="cuda", mesh=None, specs: Optional[dict] = None) -> dict:
    """The params of a checkpoint of either backend, whole on ``device``
    (or this rank's shards under ``mesh`` with ``specs``): the warm start of
    ``main_mtp --loadpath``."""
    if path.endswith(".orbax"):
        return _load_dcp(path, ("params",), device, mesh, specs)["params"]
    with open(path, "rb") as f:
        return _place(pickle.load(f)["params"], device, mesh, specs)


def load_state(path: str, template=None, device="cuda", mesh=None,
               specs: Optional[dict] = None):
    """(epoch, params, AdamState) of a checkpoint of either backend, the
    tensors whole on ``device``, or under ``mesh`` this rank's shards (every
    rank of the mesh calls it).  ``specs`` (the params' split) cuts what
    was saved whole: a pickle, or a directory saved at another tp; a
    directory saved at the mesh's tp needs none.  ``template`` is accepted
    for the JAX signature and unused: the checkpoint holds its own
    structure."""
    del template
    if mesh is not None:
        device = mesh.device
    if path.endswith(".orbax"):
        got = _load_dcp(path, ("params", "mu", "nu", "opt"), device, mesh, specs)
        return (_epoch_of(path), got["params"],
                AdamState(int(got["opt"]["count"]), got["mu"], got["nu"]))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    opt = blob["opt_state"]
    return (blob["epoch"], _place(blob["params"], device, mesh, specs),
            AdamState(int(np.asarray(opt["count"])), _place(opt["mu"], device, mesh, specs),
                      _place(opt["nu"], device, mesh, specs)))


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
    or ``state_*.orbax`` in ``cpdir``; returns the final draft params
    (float32, on ``head_w``'s device, or the mesh's).  A fresh run without
    ``dparams`` starts from ``draft.init_params`` of seed 0.

    ``mesh`` (``parallel.mesh.make_mesh``; every rank of its world calls
    ``train`` alike) makes each step the dp x sp x tp step of
    ``train/step.py``: ``cfg.bs`` must divide over dp and ``cfg.max_len``
    over sp.  The returned params are whole on every rank."""
    from .step import train_step_stage1

    _check_backend(cfg.ckpt_backend)
    device = head_w.device if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    optimizer = make_optimizer(cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.grad_clip)

    def fresh_params():
        gen = torch.Generator(device=device).manual_seed(0)
        return draft_mod.init_params(dcfg, gen, device, torch.float32)

    specs = None
    if mesh is not None:
        if cfg.bs % mesh.shape["dp"] or cfg.max_len % mesh.shape["sp"]:
            raise ValueError(f"bs {cfg.bs} must divide over dp={mesh.shape['dp']} and "
                             f"max_len {cfg.max_len} over sp={mesh.shape['sp']}")
        if dparams is None:
            dparams = fresh_params()
        specs = sharding.quantized_draft_specs(dcfg, dparams)
        head_w = sharding.local_part(head_w, sharding.P(None, "tp"), mesh.shape,
                                     mesh.coords).contiguous().to(device)
    begin_epoch = 0
    resume = latest_state(cpdir)
    if resume is not None:
        begin_epoch, dparams, opt_state = load_state(resume, device=device, mesh=mesh,
                                                     specs=specs)
        begin_epoch += 1
        if writer:
            print(f"[train] resumed from {resume} (epoch {begin_epoch})")
    else:
        if dparams is None:
            dparams = fresh_params()
        if mesh is not None:
            dparams = sharding.apply_specs(mesh, dparams, specs)
        opt_state = optimizer.init(dparams)

    # metrics stream: one JSON line of scalars every log_every steps
    os.makedirs(cpdir, exist_ok=True)
    metrics_path = os.path.join(cpdir, "metrics.jsonl")

    def log(mf, record, text):
        if writer:
            mf.write(json.dumps(record) + "\n")
            mf.flush()
            print(text)

    step = 0
    for epoch in range(begin_epoch, cfg.num_epochs):
        with open(metrics_path if writer else os.devnull, "a") as mf:
            for batch, _ in data_iterator(datadir, cfg, dcfg, seed=epoch, device=device):
                if mesh is not None:
                    batch = sharding.shard_train_batch(mesh, batch)
                if stage1:
                    dparams, opt_state, metrics = train_step_stage1(
                        dparams, opt_state, dcfg, head_w, batch, optimizer,
                        max_span=cfg.max_span_bucket, bf16=cfg.bf16, mesh=mesh)
                else:
                    dparams, opt_state, metrics = train_step(
                        dparams, opt_state, dcfg, head_w, batch, optimizer,
                        mtp_steps=cfg.mtp_steps, max_span=cfg.max_span_bucket,
                        bf16=cfg.bf16, mesh=mesh)
                if step % log_every == 0:
                    scalars = {k: float(v) for k, v in metrics.items()}
                    scalars.update(epoch=epoch, step=step)
                    log(mf, scalars, f"[train] epoch {epoch} step {step} "
                        f"loss={scalars['loss']:.4f} acc={scalars['acc']:.4f}")
                step += 1

            # per-epoch k-step rollout accuracy
            eval_files = sorted(glob.glob(os.path.join(datadir, "data_*.npz")))[:2]
            if eval_files:
                from .data_gen import load_sample

                accs = getkacc(dparams, dcfg, head_w, load_sample(eval_files[0]),
                               max_length=3, max_prefixes=4, max_len=cfg.max_len,
                               max_span=cfg.max_span_bucket, mesh=mesh)
                log(mf, {"epoch": epoch, "getkacc": accs},
                    f"[train] epoch {epoch} getkacc={accs}")
        if (epoch + 1) % cfg.save_freq == 0 or epoch == cfg.num_epochs - 1:
            save_state(cpdir, epoch, dparams, opt_state, backend=cfg.ckpt_backend,
                       mesh=mesh, specs=specs)
    return sharding.gather_params(mesh, dparams, specs)
