"""Stage-1 (text-only) draft training CLI, with the JAX package's flags in
its order, plus the port's own ``--device``:

  python -m vispec_tpu_torch.train.main --basepath <target> \
      --configpath <draft cfg> --tmpdir <npz data dir> --cpdir <ckpts> \
      [--lr 3e-5] [--num-q 2] [--ckpt-backend pickle|orbax] [--device cuda]

Stage 1 distills the EAGLE-style draft on text data with SmoothL1 on the
hiddens, soft cross-entropy and the ranking loss (v_w 1.0, p_w 0.1); its
checkpoint warm-starts stage 2 (``main_mtp --loadpath``).  ``--dp`` /
``--tp`` / ``--sp`` run the step of ``main_mtp`` under ``torchrun``.
"""

from __future__ import annotations

import argparse


def main():
    p = argparse.ArgumentParser(description="sp-stage1")
    p.add_argument("--basepath", type=str, required=True)
    p.add_argument("--configpath", type=str, required=True)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--tmpdir", type=str, default="0")
    p.add_argument("--cpdir", type=str, default="0")
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--num-q", type=int, default=2)
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--ckpt-backend", choices=["pickle", "orbax"], default="pickle")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 products with f32 master weights, losses and state")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from .main_mtp import load_head_only, mesh_or_usage_error

    mesh = mesh_or_usage_error(p, args, dp=args.dp, tp=args.tp, sp=args.sp)

    import torch

    from ..configs import DraftConfig
    from .trainer import TrainConfig, train

    dcfg = DraftConfig.from_json(args.configpath, num_q=args.num_q)
    head_w = load_head_only(args.basepath, torch.float32,
                            args.device if mesh is None else mesh.device)
    cfg = TrainConfig(lr=args.lr, bs=args.bs, num_epochs=args.num_epochs,
                      max_len=args.max_len, mtp_steps=0, ckpt_backend=args.ckpt_backend,
                      bf16=args.bf16)
    train(args.tmpdir, args.cpdir, dcfg, head_w, cfg, stage1=True, mesh=mesh)


if __name__ == "__main__":
    main()
