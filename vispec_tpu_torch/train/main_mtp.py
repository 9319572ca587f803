"""Stage-2 (multimodal MTP) training CLI on top of ``train/trainer.py``,
with the JAX package's flags in its order, plus the port's own
``--device``:

  python -m vispec_tpu_torch.train.main_mtp --basepath <target ckpt> \
      --configpath <draft config.json> --tmpdir <npz data dir> --cpdir <ckpts> \
      [--loadpath state_N.pkl|state_N.orbax] [--lr 3e-5] [--mtp-steps 2] \
      [--num-q 2] [--ckpt-backend pickle|orbax] [--device cuda]

Only the target's ``lm_head`` (or its tied embedding) is read from the
checkpoint; the full target never enters the trainer's memory.  The mesh
flags run the dp x sp x tp step under ``torchrun`` (one process per rank;
``--bs`` must divide over ``--dp`` and ``--max-len`` over ``--sp``):

  torchrun --nproc-per-node 4 -m vispec_tpu_torch.train.main_mtp ... \
      --dp 2 --tp 2 [--device cpu]
"""

from __future__ import annotations

import argparse


def mesh_or_usage_error(p: argparse.ArgumentParser, args, **axes):
    """The mesh of the mesh flags (``parallel/mesh.mesh_from_args``: None
    when every axis is 1), or ``parser.error`` with its complaint (an
    indivisible ``--bs`` / ``--max-len``, a world of another size)."""
    from ..parallel.mesh import mesh_from_args

    try:
        return mesh_from_args(bs=args.bs, max_len=args.max_len, device=args.device, **axes)
    except ValueError as e:
        p.error(str(e))


def load_head_only(basepath: str, dtype, device="cuda"):
    """Only ``lm_head`` (or the embedding, if tied) of a target checkpoint,
    as ``[hidden, vocab]`` in ``dtype`` on ``device``."""
    from ..convert.hf import load_state_dict, tensor

    sd = load_state_dict(basepath)
    for key in ("lm_head.weight", "language_model.lm_head.weight",
                "model.embed_tokens.weight", "language_model.model.embed_tokens.weight"):
        if key in sd:
            return tensor(sd, key, dtype, device, transpose=True)
    raise KeyError("no lm_head/embed_tokens in target checkpoint")


def main():
    p = argparse.ArgumentParser(description="sp")
    p.add_argument("--basepath", type=str, required=True)
    p.add_argument("--configpath", type=str, required=True)
    p.add_argument("--loadpath", type=str, default=None)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--tmpdir", type=str, default="0")
    p.add_argument("--cpdir", type=str, default="0")
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--use-ours", action="store_true", default=True)
    p.add_argument("--num-q", type=int, default=2)
    p.add_argument("--mtp-steps", type=int, default=2)
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--begin-epoch", type=int, default=0)
    p.add_argument("--ckpt-backend", choices=["pickle", "orbax"], default="pickle")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 products with f32 master weights, losses and state")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    mesh = mesh_or_usage_error(p, args, dp=args.dp, tp=args.tp, sp=args.sp)

    import torch

    from ..configs import DraftConfig
    from .trainer import TrainConfig, load_params, train

    device = args.device if mesh is None else mesh.device
    dcfg = DraftConfig.from_json(args.configpath, num_q=args.num_q)
    head_w = load_head_only(args.basepath, torch.float32, device)

    dparams = None
    if args.loadpath:
        # the params only (a stage-1 state of either backend), whole: train()
        # cuts each rank's shard
        dparams = load_params(args.loadpath, device)
        print(f"[main_mtp] warm-started from {args.loadpath}")

    cfg = TrainConfig(lr=args.lr, bs=args.bs, num_epochs=args.num_epochs,
                      max_len=args.max_len, mtp_steps=args.mtp_steps,
                      ckpt_backend=args.ckpt_backend, bf16=args.bf16)
    train(args.tmpdir, args.cpdir, dcfg, head_w, cfg, dparams=dparams, mesh=mesh)


if __name__ == "__main__":
    main()
