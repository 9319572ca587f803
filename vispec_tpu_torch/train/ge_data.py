"""Training-data generation CLI, with process-level sharding:

  python -m vispec_tpu_torch.train.ge_data --basepath <target ckpt> \
      --dataset sharegpt --data-file ShareGPT.json --outdir data/stage1 \
      --start 0 --end 10000 --shard-id 0 --num-shards 8 [--device cuda]

- sharegpt (stage 1): vicuna-template conversations; the target's forward
  captures a hidden state per token; the loss mask covers assistant turns.
- pretrain_gen (stage 2): LLaVA-Pretrain image prompts with the "Please
  answer with at least 1000 words." suffix; the image runs through the
  model's vision path, the target generates the continuation (the draft
  never trains on ground-truth text), and the saved ``image_mask`` marks
  the image-token span.

Each process handles indices ``[start + shard_id :: num_shards]``.  The
flags are the JAX package's, in its order, plus the port's ``--device``.
``--tp N`` shards the generating target over a world of N ranks
(``torchrun --nproc-per-node N -m vispec_tpu_torch.train.ge_data ... --tp
N``); every rank generates the same samples and rank 0 alone writes them.
The tokenizer comes from ``transformers`` and the images from
``PIL``, both imported only when used.
"""

from __future__ import annotations

import argparse
import json
import os

VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)
LONG_ANSWER_SUFFIX = "Please answer with at least 1000 words."


def build_sharegpt_sample(tokenizer, conv: dict, max_len: int):
    """Vicuna-template render and the assistant-turn loss mask."""
    import numpy as np

    text = VICUNA_SYSTEM
    spans = []  # (start_char, end_char) of assistant outputs
    for turn in conv.get("conversations", []):
        role = turn.get("from")
        msg = turn.get("value", "")
        if role == "human":
            text += f" USER: {msg} ASSISTANT:"
        else:
            start = len(text) + 1
            text += f" {msg}</s>"
            spans.append((start, len(text)))
    enc = tokenizer(text, return_offsets_mapping=True, truncation=True,
                    max_length=max_len)
    ids = np.asarray(enc["input_ids"], np.int32)
    offsets = enc["offset_mapping"]
    mask = np.zeros(len(ids), np.float32)
    for i, (a, b) in enumerate(offsets):
        if any(s <= a < e for s, e in spans):
            mask[i] = 1.0
    return ids, mask


def build_pretrain_ids(tokenizer, model, prompt: str, image_size, max_len: int):
    """Tokenize the image prompt and expand its one image placeholder to the
    model's image-token count for this image size
    (``SpecModel.count_image_tokens``, so it agrees with the vision path).
    Returns int32 ids, or None when the image span would not fit
    ``max_len`` whole."""
    import numpy as np

    prompt = prompt.replace("<image>", "").strip()
    text = f"{VICUNA_SYSTEM} USER: <IMG>\n{prompt} {LONG_ANSWER_SUFFIX} ASSISTANT:"
    pre, post = text.split("<IMG>")
    ids_pre = tokenizer(pre)["input_ids"]
    # the tail without a second BOS
    ids_post = tokenizer(post, add_special_tokens=False)["input_ids"]
    n_img = model.count_image_tokens(image_size)
    if len(ids_pre) + n_img > max_len:
        # a crop would cut through the image span; the caller skips it
        return None
    ids = (list(ids_pre) + [model.image_token_index] * n_img + list(ids_post))[:max_len]
    return np.asarray(ids, np.int32)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--basepath", required=True)
    p.add_argument("--dataset", choices=["sharegpt", "pretrain_gen"], required=True)
    p.add_argument("--data-file", required=True)
    p.add_argument("--image-root", default=None)
    p.add_argument("--outdir", required=True)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=10**9)
    p.add_argument("--shard-id", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from ..parallel.mesh import mesh_from_args

    try:
        mesh = mesh_from_args(tp=args.tp, device=args.device)
    except ValueError as e:
        p.error(str(e))
    writer = mesh is None or mesh.rank == 0

    import numpy as np
    import torch
    from transformers import AutoTokenizer

    from ..ops import kv_cache as kv
    from ..spec.spec_model import SpecModel, _bucket, padded_text_embeds
    from .data_gen import generate_sample, generate_vlm_sample, save_sample

    max_len = _bucket(args.max_len + args.max_new_tokens + 128)
    # a target-only load: the full architecture dispatch with its vision
    # tower, no draft
    model = SpecModel.from_pretrained(args.basepath, None, max_len=max_len,
                                      dtype=torch.bfloat16, device=args.device, mesh=mesh)
    tokenizer = AutoTokenizer.from_pretrained(args.basepath, use_fast=True)

    with open(args.data_file) as f:
        data = json.load(f)
    indices = list(range(args.start, min(args.end, len(data))))[
        args.shard_id::args.num_shards]
    print(f"[ge_data] shard {args.shard_id}/{args.num_shards}: {len(indices)} samples")

    eos = tokenizer.eos_token_id or 2
    for idx in indices:
        item = data[idx]
        if args.dataset == "sharegpt":
            ids, mask = build_sharegpt_sample(tokenizer, item, args.max_len)
            if mask.sum() == 0:
                continue
            pad = ((len(ids) + 127) // 128) * 128
            embeds = padded_text_embeds(model.tparams, ids, pad, model.device, mesh)
            # teacher-forced forward only (no generation): capture hiddens
            sample, cache = generate_sample(
                model.tparams, model.tcfg, embeds, len(ids), None,
                kv.reset(model.target_cache), max_new_tokens=1, eos_token_id=eos,
                mesh=mesh)
            model.target_cache = kv.reset(cache)
            sample["input_ids"] = ids
            sample["loss_mask"] = np.concatenate(
                [mask, np.zeros(sample["loss_mask"].shape[0] - len(mask), np.float32)]
            )[: sample["loss_mask"].shape[0]]
        else:  # pretrain_gen: image through the vision path, target generates
            prompt = item.get("conversations", [{}])[0].get("value", "")
            pixel_values = None
            image_size = None
            if args.image_root and item.get("image"):
                from PIL import Image

                img = Image.open(os.path.join(args.image_root, item["image"])).convert("RGB")
                pixel_values = np.asarray(img, np.float32) / 255.0
                image_size = pixel_values.shape[:2]
                ids = build_pretrain_ids(tokenizer, model, prompt, image_size, args.max_len)
                if ids is None:
                    print(f"[ge_data] skip {idx}: image span exceeds "
                          f"--max-len {args.max_len}")
                    continue
            else:
                text = (f"{VICUNA_SYSTEM} USER: "
                        f"{prompt.replace('<image>', '').strip()} "
                        f"{LONG_ANSWER_SUFFIX} ASSISTANT:")
                ids = np.asarray(tokenizer(text, truncation=True,
                                           max_length=args.max_len)["input_ids"], np.int32)
            sample = generate_vlm_sample(model, ids, pixel_values=pixel_values,
                                         image_size=image_size,
                                         max_new_tokens=args.max_new_tokens)
        if writer:
            save_sample(args.outdir, idx, sample)
    print("[ge_data] done")


if __name__ == "__main__":
    main()
