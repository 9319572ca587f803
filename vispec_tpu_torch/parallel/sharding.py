"""Split tables of the model parameters and caches, and the collectives the
sharded models call.

The JAX package states for each weight a ``PartitionSpec`` and lets GSPMD
insert the collectives.  Here each table gives, for each weight of the
port's layout, the mesh axis each of its dims splits over (a tuple like a
``PartitionSpec``: ``(None, "tp")`` splits the last dim over ``tp``), and
``apply_specs`` cuts this rank's shard out of the full parameters and puts
it on the rank's device.  The models then run on their local shards and
call the collectives below where a sharded product must be summed or a
sharded output joined (Megatron-LM's column- and row-parallel layers):

- ``row_dot``: the float32 product of a row-parallel weight (``wo``,
  ``w_down``, the experts' down projection) all-reduced over ``tp`` before
  the cast to the activation dtype, as the JAX products keep float32;
- ``gather_cols``: the outputs of a column-parallel weight (the draft's
  ``fc`` / ``img_fc``) joined over ``tp``;
- ``vocab_logits``: vocab-sharded logits gathered before any top-k,
  acceptance or draw (ties then break lowest index first, as on one
  device);
- ``embed_rows``: the vocab-sharded embedding lookup (each rank looks up
  the ids in its own vocab range, zeros elsewhere, then an all-reduce);
- ``stage_handoff``: the pp stage hand-off of the hidden state;
- ``sp_shard_prefill`` / ``gather_rows``: the sequence-parallel prefill's
  rows and their gather.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used, the three
ops that gloo implements for CUDA tensors as well as CPU ones.  Each call is
counted, with its host time, in ``COLLECTIVES``.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, fields
import torch
import torch.distributed as dist

from ..ops.kv_cache import KVCache
from ..ops.quant import Q4Tensor, QTensor, qdot


def P(*axes):
    """A split spec: one mesh axis name (or None) per dim."""
    return tuple(axes)


# ---------------------------------------------------------------------------
# Split tables (the JAX package's spec functions, over the port's layout)
# ---------------------------------------------------------------------------


def llama_param_specs(cfg) -> dict:
    """Splits of ``models/llama.py``'s parameters: heads and MLP columns
    over tp (column-parallel), ``wo`` / ``w_down`` rows over tp
    (row-parallel), vocab-sharded embed and head."""
    layers = {
        "input_norm": P(None, None),
        "post_norm": P(None, None),
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
        "w_gate": P(None, None, "tp"),
        "w_up": P(None, None, "tp"),
        "w_down": P(None, "tp", None),
    }
    if cfg.qkv_bias:
        layers["bq"] = P(None, "tp")
        layers["bk"] = P(None, "tp")
        layers["bv"] = P(None, "tp")
    return {
        "embed": P("tp", None),
        "layers": layers,
        "final_norm": P(None),
        "lm_head": P(None, "tp"),
    }


def draft_param_specs(cfg) -> dict:
    layer = {
        "post_norm": P(None),
        "wq": P(None, "tp"),
        "wk": P(None, "tp"),
        "wv": P(None, "tp"),
        "wo": P("tp", None),
        "w_gate": P(None, "tp"),
        "w_up": P(None, "tp"),
        "w_down": P("tp", None),
    }
    if cfg.qkv_bias:
        layer.update({"bq": P("tp"), "bk": P("tp"), "bv": P("tp")})
    adaptor = {
        "q": P(None, "tp", None),
        "wk": P(None, "tp"),
        "wv": P(None, "tp"),
        "wo": P("tp", None),
    }
    if cfg.qkv_bias:
        adaptor.update({"bk": P("tp"), "bv": P("tp")})
    specs = {
        "embed": P("tp", None),
        "layer": layer,
        "adaptor": adaptor,
        "fc_w": P(None, "tp"),
        "img_fc_w": P(None, "tp"),
    }
    if cfg.fc_bias:
        specs["fc_b"] = P("tp")
        specs["img_fc_b"] = P("tp")
    return specs


def _quant_leaf_spec(leaf, sp):
    """Spec node of one possibly-quantized weight, from the spec its plain
    weight would carry: an int8 ``QTensor``'s scale splits with the output
    axis; an int4 ``Q4Tensor`` splits on N when column-parallel and is
    replicated when row-parallel (a packed row holds original rows r and
    r + K/2, so a contiguous shard of packed rows cannot match the
    activations' contiguous K shard; ``row_dot`` gathers the activation
    for it instead)."""
    if isinstance(leaf, QTensor):
        return QTensor(q=sp, s=P(*sp[:-2], sp[-1]) if len(sp) else P())
    if isinstance(leaf, Q4Tensor):
        if len(sp) == 2 and sp[0] is None:
            return Q4Tensor(packed=sp, s=P(None, sp[1]))
        return Q4Tensor(packed=P(None, None), s=P(None, None))
    return sp


def quantized_draft_specs(cfg, dparams: dict) -> dict:
    """Splits of a ``quantize_draft_params()`` draft (any mode), walking the
    actual parameters: ``rank_head`` is vocab-sharded like ``lm_head``; the
    fuse folds ``fuse_we`` / ``fuse_wh`` are replicated; a key the table
    does not know is replicated."""
    base = draft_param_specs(cfg)
    extra = {"rank_head": P(None, "tp"),
             "fuse_we": P(None, None), "fuse_wh": P(None, None)}
    specs = {}
    for key, val in dparams.items():
        if key == "layer":
            specs["layer"] = {k: _quant_leaf_spec(v, base["layer"][k])
                              for k, v in val.items()}
        else:
            sp = base.get(key, extra.get(key))
            if sp is None:
                sp = P(*(None,) * len(getattr(val, "shape", ())))
            specs[key] = _quant_leaf_spec(val, sp)
    return specs


def quantize_aware_specs(specs, params):
    """Overlay a plain spec tree onto possibly-quantized parameters: a
    ``QTensor`` / ``Q4Tensor`` leaf takes field-wise specs
    (``_quant_leaf_spec``); a key the table does not know is replicated."""
    if isinstance(params, (QTensor, Q4Tensor)):
        return _quant_leaf_spec(params, specs)
    if isinstance(params, dict):
        return {k: quantize_aware_specs(specs[k], v) if k in specs
                else P(*(None,) * len(getattr(v, "shape", ())))
                for k, v in params.items()}
    return specs


def mixtral_param_specs(cfg) -> dict:
    """Expert parallelism over the tp axis: the port holds gate and up as
    ``[L, hidden, E * inter]``, so their split takes whole blocks of
    ``inter`` columns (E / tp experts per rank); the down projection
    ``[L, E, inter, hidden]`` splits its expert axis.  The router stays
    replicated, as in the JAX package."""
    specs = llama_param_specs(cfg)
    layers = {k: v for k, v in specs["layers"].items()
              if k not in ("w_gate", "w_up", "w_down")}
    layers.update({
        "router": P(None, None, None),
        "we_gate": P(None, None, "tp"),
        "we_up": P(None, None, "tp"),
        "we_down": P(None, "tp", None, None),
    })
    specs["layers"] = layers
    return specs


def _over_pp(specs: dict) -> dict:
    specs["layers"] = {k: P("pp", *s[1:]) for k, s in specs["layers"].items()}
    return specs


def llama_param_specs_pp(cfg) -> dict:
    """Layer-stage placement: the stacked ``[L, ...]`` layer weights split
    by depth over pp, composed with tp on the inner dims."""
    return _over_pp(llama_param_specs(cfg))


def mixtral_param_specs_pp(cfg) -> dict:
    """Layer-stage placement of the MoE target; experts stay split over tp
    within each stage."""
    return _over_pp(mixtral_param_specs(cfg))


def kv_cache_specs(pp: bool = False, h_ax="tp", quantized: bool = False) -> KVCache:
    """Splits of a ``KVCache``: KV heads over tp, layers over pp when asked;
    lengths replicated.  ``h_ax=None`` replicates the head axis."""
    l_ax = "pp" if pp else None
    return KVCache(
        k=P(l_ax, h_ax, None, None), v=P(l_ax, h_ax, None, None),
        length=P(), real_length=P(),
        k_scale=P(l_ax, h_ax, None) if quantized else None,
        v_scale=P(l_ax, h_ax, None) if quantized else None)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def local_part(x: torch.Tensor, spec, shape: dict, coords: dict) -> torch.Tensor:
    """The block of ``x`` that the rank at ``coords`` holds under ``spec``
    (a view); each split dim must divide by its axis size."""
    index = []
    for dim, axis in enumerate(spec):
        if axis is None or shape[axis] == 1:
            index.append(slice(None))
            continue
        n = shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(x.shape)} tensor does not divide "
                             f"over {axis}={n}")
        step = x.shape[dim] // n
        index.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
    return x[tuple(index)]


def _place(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    part = local_part(x, spec, mesh.shape, mesh.coords)
    # a copy of its own, so that the full tensor can be freed
    return torch.empty(part.shape, dtype=part.dtype, device=mesh.device).copy_(part)


def apply_specs(mesh, params: dict, specs: dict) -> dict:
    """This rank's shard of a parameter tree on ``mesh.device``; quantized
    leaves pair with a same-type spec node and are cut field by field."""

    def put(x, s):
        if isinstance(x, dict):
            return {k: put(v, s[k]) for k, v in x.items()}
        if isinstance(x, (QTensor, Q4Tensor)):
            return type(x)(**{f.name: _place(getattr(x, f.name), getattr(s, f.name), mesh)
                              for f in fields(x)})
        return _place(x, s, mesh)

    return put(params, specs)


def _cache_splits(mesh, layers: int, heads: int, pp: bool, warn: bool):
    """(split heads over tp?, split layers over pp?) for a cache, with the
    JAX package's two warnings when a multi-head / multi-layer cache must
    be replicated instead."""
    tp, pp_n = mesh.shape["tp"], mesh.shape["pp"]
    tp_ok = heads % tp == 0
    pp_ok = pp and layers % pp_n == 0
    if warn and not tp_ok and heads > 1:
        warnings.warn(
            f"KV cache with {heads} heads does not divide tp={tp}; replicating the "
            f"full cache on every rank (pick tp dividing the KV head count to shard it)",
            stacklevel=3)
    if warn and pp and not pp_ok and layers > 1:
        warnings.warn(
            f"KV cache with {layers} layers does not divide pp={pp_n}; every stage will "
            f"hold the full layer axis (pick pp dividing the layer count to split it)",
            stacklevel=3)
    return tp_ok, pp_ok


def local_cache_dims(mesh, layers: int, heads: int, pp: bool = False) -> tuple:
    """(layers, KV heads) of this rank's cache: what ``shard_cache`` would
    cut, for allocating a local cache directly."""
    if mesh is None:
        return layers, heads
    tp_ok, pp_ok = _cache_splits(mesh, layers, heads, pp, warn=False)
    return (layers // mesh.shape["pp"] if pp_ok else layers,
            heads // mesh.shape["tp"] if tp_ok else heads)


def shard_cache(mesh, cache: KVCache, pp: bool = False) -> KVCache:
    """This rank's part of a ``KVCache``: heads split over tp (and layers
    over pp when asked).  An axis that does not divide replicates instead,
    with a warning when a multi-head (multi-layer) cache is replicated."""
    tp_ok, pp_ok = _cache_splits(mesh, cache.k.shape[0], cache.k.shape[1], pp, warn=True)
    specs = kv_cache_specs(pp=pp_ok, h_ax="tp" if tp_ok else None,
                           quantized=cache.k_scale is not None)
    return KVCache(**{f.name: (None if getattr(cache, f.name) is None else
                               _place(getattr(cache, f.name), getattr(specs, f.name), mesh))
                      for f in fields(KVCache)})


def sp_shard_prefill(mesh, inputs_embeds: torch.Tensor, position_ids=None):
    """This rank's rows of a sequence-parallel prefill: the prompt's token
    axis (dim -2 of ``inputs_embeds``) split over sp, and the matching
    columns of ``position_ids`` (the last dim: also Qwen's ``[3, S]``
    M-RoPE ids) when given."""
    n, i = mesh.shape["sp"], mesh.coords["sp"]
    s = inputs_embeds.shape[-2]
    if s % n:
        raise ValueError(f"a prefill of {s} rows does not split over sp={n}")
    rows = slice(i * (s // n), (i + 1) * (s // n))
    emb = inputs_embeds[..., rows, :]
    if position_ids is None:
        return emb
    return emb, position_ids[..., rows]


def sp_active(mesh, region) -> bool:
    """Whether a forward splits its rows over sp: a prefill (no verify
    region) on a mesh with sp > 1."""
    return mesh is not None and region is None and mesh.shape["sp"] > 1


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@dataclass
class CollectiveStats:
    """Calls and host seconds of each collective since the last ``reset``."""

    calls: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def reset(self) -> None:
        self.calls.clear()
        self.seconds.clear()

    def add(self, op: str, seconds: float) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.seconds[op] = self.seconds.get(op, 0.0) + seconds

    @property
    def total_calls(self) -> int:
        return sum(self.calls.values())

    @property
    def total_seconds(self) -> float:
        return sum(self.seconds.values())


COLLECTIVES = CollectiveStats()


def _active(mesh, axis: str) -> bool:
    return mesh is not None and mesh.shape[axis] > 1


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A 2-byte float tensor as bytes for data-moving collectives (the same
    bits; gloo has no 2-byte integer type and no bfloat16 on every build)."""
    return x.view(torch.uint8) if x.dtype in (torch.bfloat16, torch.float16) else x


def all_reduce(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Sum of ``x`` over the mesh axis (returns a new tensor)."""
    if not _active(mesh, axis):
        return x
    t0 = time.perf_counter()
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.groups[axis])
    COLLECTIVES.add("all_reduce", time.perf_counter() - t0)
    return out


def all_gather(x: torch.Tensor, mesh, axis: str = "tp", dim: int = -1) -> torch.Tensor:
    """The axis members' ``x`` concatenated along ``dim`` in axis order."""
    if not _active(mesh, axis):
        return x
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather([_wire(p) for p in parts], _wire(x), group=mesh.groups[axis])
    out = torch.cat(parts, dim=dim)
    COLLECTIVES.add("all_gather", time.perf_counter() - t0)
    return out


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The ``x`` of the axis member at index ``src``, on every member."""
    if not _active(mesh, axis):
        return x
    t0 = time.perf_counter()
    out = x.contiguous() if mesh.coords[axis] == src else torch.empty_like(x)
    dist.broadcast(_wire(out), src=mesh.members[axis][src], group=mesh.groups[axis])
    COLLECTIVES.add("broadcast", time.perf_counter() - t0)
    return out


def row_dot(x: torch.Tensor, w, mesh) -> torch.Tensor:
    """float32 ``x @ w`` of a row-parallel weight: the local partial
    product summed over tp.  A weight left whole (a row-parallel int4
    weight, see ``_quant_leaf_spec``) takes the gathered activation
    instead, and needs no sum."""
    if not _active(mesh, "tp"):
        return qdot(x, w)
    if w.shape[-2] != x.shape[-1]:
        return qdot(all_gather(x, mesh, "tp"), w)
    return all_reduce(qdot(x, w), mesh, "tp")


def gather_cols(y: torch.Tensor, mesh) -> torch.Tensor:
    """The full output of a column-parallel product from the local columns."""
    return all_gather(y, mesh, "tp", dim=-1)


def vocab_logits(x: torch.Tensor, w, mesh) -> torch.Tensor:
    """float32 logits ``x @ w`` of a vocab-sharded head, gathered over tp so
    that every rank ranks and draws over the whole vocab."""
    return gather_cols(qdot(x, w), mesh)


def embed_rows(table: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """Rows of ``ids`` (any shape) from a vocab-sharded table ``[V / tp,
    hidden]``: each rank looks up the ids in its own vocab range and zeros
    elsewhere, and the sum over tp holds each row once."""
    flat = ids.reshape(-1).to(torch.int64)
    if not _active(mesh, "tp"):
        return table.index_select(0, flat).reshape(*ids.shape, -1)
    rows = table.shape[0]
    local = flat - mesh.coords["tp"] * rows
    hit = (local >= 0) & (local < rows)
    part = table.index_select(0, local.clamp(0, rows - 1)).float() * hit[:, None]
    return all_reduce(part, mesh, "tp").to(table.dtype).reshape(*ids.shape, -1)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The full sequence of a sequence-parallel prefill from each rank's
    rows (dim -2)."""
    return all_gather(x, mesh, "sp", dim=-2)


def stage_handoff(x: torch.Tensor, mesh, stage: int) -> torch.Tensor:
    """Stage ``stage``'s output on every pp stage (the hand-off to the next
    stage; the last stage's reaches every rank)."""
    return broadcast(x, mesh, "pp", stage)

