"""Unified evaluation CLI -- the reference's gen_{spec,baseline}_answer_<bench>
scripts behind one entry point:

  python -m vispec_tpu_torch.evaluation.gen_answer \
      --bench sqa --model <target ckpt dir> --spec-model <draft ckpt dir> \
      --answer-file out/sqa.jsonl --data-root /data [--baseline] \
      --total-token 30 --depth 3 --top-k 8 --num-q 2 --temperature 0.0 \
      [--device cuda]

The JAX package's flags in its order, plus the port's own ``--device``
(default ``cuda``; ``cpu`` runs the plain versions of the kernels).  The
model loads through ``SpecModel.from_pretrained``.  ``--tp``, ``--pp`` and
``--sp`` shard one model over a world of ``tp * pp * sp`` ranks:

  torchrun --nproc-per-node 2 -m vispec_tpu_torch.evaluation.gen_answer \
      ... --tp 2

Every rank loads the checkpoint, keeps its shard and generates the same
answers; rank 0 alone writes the answer file.  Scale-out: run several
processes with disjoint --question-begin/--question-end.
"""

from __future__ import annotations

import argparse
import json
import os


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--bench", required=True)
    p.add_argument("--model", required=True, help="target model checkpoint dir")
    p.add_argument("--spec-model", default=None, help="draft checkpoint dir")
    p.add_argument("--method", default="vispec", choices=["vispec", "eagle", "medusa"])
    p.add_argument("--baseline", action="store_true")
    p.add_argument("--answer-file", required=True)
    p.add_argument("--data-root", default="data")
    p.add_argument("--model-id", default=None)
    p.add_argument("--question-begin", type=int, default=0)
    p.add_argument("--question-end", type=int, default=10**9)
    p.add_argument("--total-token", type=int, default=30)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--top-k", type=int, default=8)
    p.add_argument("--num-q", type=int, default=2)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--seed", type=int, default=42)
    # Qwen image-token budgets: they must match the device-side smart_resize
    p.add_argument("--min-pixels", type=int, default=256 * 28 * 28)
    p.add_argument("--max-pixels", type=int, default=1280 * 28 * 28)
    # per-frame video budget (360*420 for the video benches, else 768*28*28)
    p.add_argument("--video-max-pixels", type=int, default=None)
    p.add_argument("--conv-template", default=None,
                   choices=[None, "vicuna", "qwen", "llama3"],
                   help="MT-bench chat template; default: resolved from the "
                        "model path (harness.get_conv_template)")
    p.add_argument("--quantize-draft", nargs="?", const="int8", default=None,
                   choices=["int8", "int4", "int4_head", "mixed", "auto"],
                   help="weight-only draft quantization (ops/quant.py); bare flag = int8")
    p.add_argument("--quantize-target", action="store_true",
                   help="weight-only int8 on the target (outputs change)")
    p.add_argument("--quantize-kv", action="store_true",
                   help="int8 KV cache (outputs change)")
    p.add_argument("--repetition-penalty", type=float, default=1.0)
    p.add_argument("--prefix-cache", action="store_true",
                   help="multi-turn benches: continue each turn from the "
                        "previous turn's snapshot instead of re-prefilling")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from ..parallel.mesh import mesh_from_args

    try:
        mesh = mesh_from_args(tp=args.tp, pp=args.pp, sp=args.sp, device=args.device)
    except ValueError as e:
        p.error(str(e))
    if args.video_max_pixels is None:
        args.video_max_pixels = (360 * 420 if args.bench in ("mvbench", "msvd_qa")
                                 else 768 * 28 * 28)

    from transformers import AutoProcessor, AutoTokenizer

    from ..spec.spec_model import SpecModel
    from .benchmarks import iter_questions
    from .harness import get_conv_template, run_eval

    with open(os.path.join(args.model, "config.json")) as f:
        arch = json.load(f)["architectures"][0]
    proc_kwargs = {}
    if arch == "Qwen2_5_VLForConditionalGeneration":
        proc_kwargs = dict(use_fast=True, min_pixels=args.min_pixels,
                           max_pixels=args.max_pixels)
    try:
        processor = AutoProcessor.from_pretrained(args.model, **proc_kwargs)
        tokenizer = getattr(processor, "tokenizer", processor)
    except Exception:
        tokenizer = AutoTokenizer.from_pretrained(args.model)
        processor = tokenizer

    model = SpecModel.from_pretrained(
        base_model_path=args.model,
        spec_model_path=args.spec_model or args.model,
        total_token=args.total_token,
        depth=args.depth,
        top_k=args.top_k,
        num_q=args.num_q,
        max_len=args.max_len,
        method=args.method,
        min_pixels=args.min_pixels,
        max_pixels=args.max_pixels,
        video_max_pixels=args.video_max_pixels,
        quantize_draft=args.quantize_draft or False,
        quantize_kv=args.quantize_kv,
        device=args.device,
        # a quantized target is sharded after its quantization
        mesh=None if args.quantize_target else mesh,
        pp=args.pp > 1, sp=args.sp > 1,
    )
    if args.quantize_target:
        # right after the load: each bf16 matrix is freed as its int8 copy lands
        model.quantize_target_inplace()
        if mesh is not None:
            model.shard_over(mesh, pp=args.pp > 1, sp=args.sp > 1)

    questions = list(iter_questions(args.bench, processor, args.data_root,
                                    args.question_begin, args.question_end))
    print(f"[gen_answer] {args.bench}: {len(questions)} questions")

    records = run_eval(
        model,
        questions,
        args.answer_file if mesh is None or mesh.rank == 0 else None,
        baseline=args.baseline,
        temperature=args.temperature,
        max_new_tokens=args.max_new_tokens,
        decode_fn=lambda ids: tokenizer.decode(ids, skip_special_tokens=True),
        model_id=args.model_id or f"{os.path.basename(args.model)}-{args.method}",
        seed_base=args.seed,
        tokenizer=tokenizer,
        conv_template=args.conv_template or get_conv_template(args.model),
        gen_kwargs=({"repetition_penalty": args.repetition_penalty}
                    if args.repetition_penalty != 1.0 else None),
        prefix_cache=args.prefix_cache,
    )
    taus = [a + 1 for r in records for a in r.get("acceptance_length", [])]
    if taus:
        print(f"[gen_answer] mean tau = {sum(taus) / len(taus):.3f}")


if __name__ == "__main__":
    main()
