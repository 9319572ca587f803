"""Medusa heads training CLI, with the JAX package's flags in its order,
plus the port's own ``--device``:

  python -m vispec_tpu_torch.train.main_medusa --basepath <target> \
      --tmpdir <npz data dir> --cpdir <ckpts> [--lr 3e-5] [--device cuda]

``--dp`` / ``--sp`` split the batch and the sequence under ``torchrun``;
the heads are small and replicate on every rank, and rank 0 writes the
state.
"""

from __future__ import annotations

import argparse


def main():
    p = argparse.ArgumentParser(description="sp-medusa")
    p.add_argument("--basepath", type=str, required=True)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--tmpdir", type=str, default="0")
    p.add_argument("--cpdir", type=str, default="0")
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 products with f32 master weights, losses and state")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from .main_mtp import load_head_only, mesh_or_usage_error

    mesh = mesh_or_usage_error(p, args, dp=args.dp, sp=args.sp)

    import torch

    from ..configs import DraftConfig
    from ..models import medusa as medusa_mod
    from ..parallel.sharding import shard_train_batch
    from .step import make_optimizer, train_step_medusa
    from .trainer import TrainConfig, data_iterator, latest_state, load_state, save_state

    device = args.device if mesh is None else mesh.device
    head_w = load_head_only(args.basepath, torch.float32, device)
    d = head_w.shape[0]
    dcfg = DraftConfig(hidden_size=d, vocab_size=head_w.shape[1])
    cfg = TrainConfig(lr=args.lr, bs=args.bs, num_epochs=args.num_epochs,
                      max_len=args.max_len)

    optimizer = make_optimizer(cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.grad_clip)
    begin = 0
    resume = latest_state(args.cpdir)
    if resume:
        begin, mparams, opt_state = load_state(resume, device=device)
        begin += 1
    else:
        mparams = medusa_mod.init_params(d, device, torch.float32)
        opt_state = optimizer.init(mparams)

    step = 0
    for epoch in range(begin, cfg.num_epochs):
        for batch, _ in data_iterator(args.tmpdir, cfg, dcfg, seed=epoch, device=device):
            if mesh is not None:
                batch = shard_train_batch(mesh, batch)
            mparams, opt_state, metrics = train_step_medusa(
                mparams, opt_state, head_w, batch, optimizer, bf16=args.bf16, mesh=mesh)
            if step % 20 == 0 and (mesh is None or mesh.rank == 0):
                print(f"[medusa] epoch {epoch} step {step} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"acc={float(metrics['acc']):.4f}")
            step += 1
        save_state(args.cpdir, epoch, mparams, opt_state, mesh=mesh)


if __name__ == "__main__":
    main()
