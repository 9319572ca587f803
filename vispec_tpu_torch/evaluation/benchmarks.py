"""Benchmark registry: dataset loaders + prompt builders for the reference's
15 evaluation suites (SURVEY.md §2.3) -- the PyTorch port's own copy of
``vispec_tpu/evaluation/benchmarks.py`` (it holds no JAX; the port keeps
its own copies of such modules, and of the vendored MT-bench questions).

Each reference script pair gen_{spec,baseline}_answer_<bench>.py shares a
`build_prompt` that applies the HF chat template + processor and returns model
inputs (e.g. mme_prompt.py:1-49, coco_caption_prompt.py, scienceqa_prompt.py:
100-208).  Here every benchmark is a registry entry:

    loader(data_root, begin, end) -> iterable of raw samples
    messages(sample) -> (chat messages, images, category)

and one shared ``build_inputs`` turns them into SpecModel inputs: input_ids
come from the HF processor (which expands <image> tokens to the correct count
for anyres / dynamic-resolution), while the RAW image rides along so pixel
preprocessing runs device-side in our stack (not the torch processor's CPU
path).  Dataset files are read from --data-root in their canonical layouts; HF
hub datasets (gqa, vqav2, seed_bench, ...) load via `datasets` when available.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List

import numpy as np

SYSTEM_PROMPT = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions."
)


def _msg(text_parts: List[str], n_images: int = 1) -> List[dict]:
    content = [{"type": "text", "text": t} for t in text_parts]
    content += [{"type": "image"}] * n_images
    return [
        {"role": "system", "content": [{"type": "text", "text": SYSTEM_PROMPT}]},
        {"role": "user", "content": content},
    ]


def build_inputs(processor, messages: List[dict], images: List) -> Dict[str, Any]:
    """Chat template + tokenize (with image-token expansion) + raw pixels."""
    prompt = processor.apply_chat_template(messages, add_generation_prompt=True)
    if images:
        enc = processor(images=images, text=prompt, return_tensors="np")
    else:
        enc = processor.tokenizer(prompt, return_tensors="np") if hasattr(
            processor, "tokenizer") else processor(text=prompt, return_tensors="np")
    out: Dict[str, Any] = {"input_ids": np.asarray(enc["input_ids"][0])}
    if images:
        img = images[0]
        arr = np.asarray(img, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        out["pixel_values"] = arr[..., :3]
        out["image_size"] = arr.shape[:2]
    return out


# ---------------------------------------------------------------------------
# Dataset loaders (canonical layouts per the reference prompt modules)
# ---------------------------------------------------------------------------


def _load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def _img(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def _hf_dataset(root, local_name, hub_id, split):
    """Offline-first HF dataset: a save_to_disk copy under --data-root wins,
    falling back to the hub (the reference always hits the hub,
    gen_spec_answer_sqa.py:28 — offline TPU pods need the local path)."""
    from datasets import load_dataset, load_from_disk

    local = os.path.join(root or "", local_name)
    if root and os.path.isdir(local):
        ds = load_from_disk(local)
        if hasattr(ds, "keys") and split in ds:
            ds = ds[split]
        return ds
    return load_dataset(hub_id, split=split)


def load_sqa(root, begin, end):
    """ScienceQA: local save_to_disk copy at {root}/scienceqa or HF
    derek-thomas/ScienceQA (gen_spec_answer_sqa.py:24-67)."""
    try:
        ds = _hf_dataset(root, "scienceqa", "derek-thomas/ScienceQA", "test")
        items = [d for d in ds if d.get("image") is not None][begin:end]
        for i, d in enumerate(items):
            opts = "".join(
                f"\n{chr(ord('A') + j)}. {c}" for j, c in enumerate(d["choices"])
            )
            text = f"{d['question']}{opts}\nAnswer with the option's letter from the given choices directly."
            yield dict(qid=begin + i, text=text, image=d["image"], category=d.get("topic", ""))
    except Exception as e:
        raise RuntimeError(f"scienceqa requires the HF dataset or local data: {e}")


def load_mme(root, begin, end):
    """MME: {root}/mme/... per-category dirs with questions_answers + images."""
    base = os.path.join(root, "MME")
    idx = 0
    for cat in sorted(os.listdir(base)):
        qa_dir = os.path.join(base, cat, "questions_answers_YN")
        img_dir = os.path.join(base, cat, "images")
        if not os.path.isdir(qa_dir):
            qa_dir = img_dir = os.path.join(base, cat)
        for fn in sorted(os.listdir(qa_dir)):
            if not fn.endswith(".txt"):
                continue
            with open(os.path.join(qa_dir, fn)) as f:
                for line in f:
                    q = line.split("\t")[0].strip()
                    if not q:
                        continue
                    if begin <= idx < end:
                        img_path = os.path.join(img_dir, fn.replace(".txt", ".jpg"))
                        if not os.path.exists(img_path):
                            img_path = img_path.replace(".jpg", ".png")
                        yield dict(qid=idx, text=q, image=_img(img_path), category=cat)
                    idx += 1


def load_coco_caption(root, begin, end):
    """COCO captions: {root}/coco/annotations/captions_val2017.json + images."""
    ann = json.load(open(os.path.join(root, "coco", "annotations", "captions_val2017.json")))
    images = {im["id"]: im["file_name"] for im in ann["images"]}
    ids = sorted(images)[begin:end]
    for i, iid in enumerate(ids):
        path = os.path.join(root, "coco", "val2017", images[iid])
        yield dict(qid=iid, text=None, image=_img(path), category="caption")


def load_textvqa(root, begin, end):
    data = json.load(open(os.path.join(root, "textvqa", "TextVQA_0.5.1_val.json")))["data"]
    for d in data[begin:end]:
        path = os.path.join(root, "textvqa", "train_images", d["image_id"] + ".jpg")
        yield dict(qid=d["question_id"], text=d["question"], image=_img(path), category="")


def load_vizwiz(root, begin, end):
    data = json.load(open(os.path.join(root, "vizwiz", "val.json")))
    for i, d in enumerate(data[begin:end]):
        path = os.path.join(root, "vizwiz", "val", d["image"])
        yield dict(qid=begin + i, text=d["question"], image=_img(path), category="")


def load_gqa(root, begin, end):
    qfile = os.path.join(root, "gqa", "testdev_balanced_questions.json")
    data = json.load(open(qfile))
    keys = sorted(data)[begin:end]
    for k in keys:
        d = data[k]
        path = os.path.join(root, "gqa", "images", d["imageId"] + ".jpg")
        yield dict(qid=k, text=d["question"], image=_img(path), category="")


def load_vqav2(root, begin, end):
    q = json.load(open(os.path.join(
        root, "vqav2", "v2_OpenEnded_mscoco_val2014_questions.json")))["questions"]
    for d in q[begin:end]:
        fn = f"COCO_val2014_{d['image_id']:012d}.jpg"
        path = os.path.join(root, "vqav2", "val2014", fn)
        yield dict(qid=d["question_id"], text=d["question"], image=_img(path), category="")


def load_mmvet(root, begin, end):
    data = json.load(open(os.path.join(root, "mm-vet", "mm-vet.json")))
    keys = sorted(data)[begin:end]
    for k in keys:
        d = data[k]
        path = os.path.join(root, "mm-vet", "images", d["imagename"])
        yield dict(qid=k, text=d["question"], image=_img(path), category="")


def load_seed_bench(root, begin, end):
    data = json.load(open(os.path.join(root, "seed_bench", "SEED-Bench.json")))["questions"]
    data = [d for d in data if d.get("data_type") == "image"][begin:end]
    for d in data:
        path = os.path.join(root, "seed_bench", "SEED-Bench-image", d["data_id"])
        opts = "".join(
            f"\n{c}. {d['choice_' + c.lower()]}" for c in "ABCD" if ("choice_" + c.lower()) in d
        )
        text = f"{d['question']}{opts}\nAnswer with the option's letter from the given choices directly."
        yield dict(qid=d["question_id"], text=text, image=_img(path), category="")


def load_synthdog(root, begin, end):
    """SynthDoG OCR: local copy at {root}/synthdog or the HF dataset."""
    try:
        ds = _hf_dataset(root, "synthdog", "naver-clova-ix/synthdog-en",
                         "validation")
        for i, d in enumerate(list(ds)[begin:end]):
            yield dict(qid=begin + i, text="Please read all text in the image.",
                       image=d["image"], category="ocr")
    except Exception as e:
        raise RuntimeError(f"synthdog requires the HF dataset: {e}")


def load_hr_bench(root, begin, end):
    """HR-Bench 4K: local copy at {root}/hr_bench or the HF dataset."""
    try:
        import io
        from PIL import Image

        ds = _hf_dataset(root, "hr_bench", "DreamMr/HR-Bench", "hrbench_4k")
        for i, d in enumerate(list(ds)[begin:end]):
            img = d["image"]
            if isinstance(img, (bytes, bytearray)):
                img = Image.open(io.BytesIO(img)).convert("RGB")
            text = (f"{d['question']}\nA. {d['A']}\nB. {d['B']}\nC. {d['C']}\nD. {d['D']}\n"
                    "Answer with the option's letter from the given choices directly.")
            yield dict(qid=begin + i, text=text, image=img, category=d.get("category", ""))
    except Exception as e:
        raise RuntimeError(f"hr_bench requires the HF dataset: {e}")


def load_mmbench(root, begin, end):
    import base64
    import csv
    import io

    from PIL import Image

    path = os.path.join(root, "mmbench", "mmbench_dev_20230712.tsv")
    with open(path) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    for d in rows[begin:end]:
        img = Image.open(io.BytesIO(base64.b64decode(d["image"]))).convert("RGB")
        opts = "".join(
            f"\n{c}. {d[c]}" for c in "ABCD" if d.get(c)
        )
        text = (f"{d.get('hint', '')}\n{d['question']}{opts}\n"
                "Answer with the option's letter from the given choices directly.")
        yield dict(qid=d["index"], text=text, image=img, category=d.get("category", ""))


def load_vicuna(root, begin, end):
    """MT-bench text-only questions, all turns — the harness decodes every
    turn carrying the conversation (gen_spec_answer_vicuna.py:160-275).

    The 80 LMSYS MT-bench questions are vendored
    (vispec_tpu_torch/data/mt_bench/question.jsonl, as the reference vendors
    vispec/data/mt_bench/) so the bench runs out of the box; a copy under
    ``root`` takes precedence.  The speed harness never judges, so the judge
    data is not vendored here."""
    path = os.path.join(root, "mt_bench", "question.jsonl")
    if not os.path.exists(path):
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "mt_bench", "question.jsonl")
    for d in _load_jsonl(path)[begin:end]:
        yield dict(qid=d["question_id"], text=None, image=None,
                   turns=list(d["turns"]), category=d.get("category", ""))


MAX_FRAMES = 8  # reference mvbench_prompt.py:24-52 (qwen_vl_utils max_frames)


def _load_frames(frame_dir: str):
    """Up to MAX_FRAMES uniformly-sampled frames from a directory of images
    (video decode is host-side; pre-extract frames with ffmpeg)."""
    import numpy as np

    files = sorted(
        f for f in os.listdir(frame_dir) if f.lower().endswith((".jpg", ".png"))
    )
    if not files:
        raise FileNotFoundError(f"no frames in {frame_dir}")
    idx = np.linspace(0, len(files) - 1, min(MAX_FRAMES, len(files))).astype(int)
    return [_img(os.path.join(frame_dir, files[i])) for i in idx]


def load_msvd_qa(root, begin, end):
    """MSVD-QA: {root}/msvd/qa_test.json + frames/<video_id>/*.jpg."""
    data = json.load(open(os.path.join(root, "msvd", "qa_test.json")))
    for d in data[begin:end]:
        frames = _load_frames(os.path.join(root, "msvd", "frames", str(d["video_id"])))
        yield dict(qid=d.get("id", d["video_id"]), text=d["question"],
                   image=None, frames=frames, category="video")


def load_mvbench(root, begin, end):
    """MVBench: {root}/mvbench/json/<task>.json + frames/<video>/*.jpg."""
    base = os.path.join(root, "mvbench")
    idx = 0
    for task_file in sorted(os.listdir(os.path.join(base, "json"))):
        task = task_file[:-5]
        for d in json.load(open(os.path.join(base, "json", task_file))):
            if begin <= idx < end:
                frames = _load_frames(
                    os.path.join(base, "frames", os.path.splitext(d["video"])[0])
                )
                opts = "".join(
                    f"\n({chr(ord('A') + j)}) {c}"
                    for j, c in enumerate(d.get("candidates", []))
                )
                text = (f"{d['question']}{opts}\n"
                        "Answer with the option's letter from the given choices directly.")
                yield dict(qid=idx, text=text, image=None, frames=frames,
                           category=task)
            idx += 1


# instruction appended per benchmark (mirrors each *_prompt.py)
EXTRA_INSTRUCTION = {
    "mme": "Please answer with an explanation.",
    "coco_caption": None,
    "sqa": None,
}

CAPTION_TEXT = "Please provide a detailed description of the given image."

REGISTRY: Dict[str, Callable] = {
    "sqa": load_sqa,
    "mme": load_mme,
    "coco_caption": load_coco_caption,
    "textvqa": load_textvqa,
    "vizwiz": load_vizwiz,
    "gqa": load_gqa,
    "vqav2": load_vqav2,
    "mmvet": load_mmvet,
    "seed_bench": load_seed_bench,
    "synthdog": load_synthdog,
    "hr_bench": load_hr_bench,
    "mmbench": load_mmbench,
    "vicuna": load_vicuna,
    "msvd_qa": load_msvd_qa,
    "mvbench": load_mvbench,
}


def iter_questions(bench: str, processor, data_root: str, begin: int = 0,
                   end: int = 10**9):
    """Yield harness.Question objects for a benchmark."""
    from .harness import Question

    loader = REGISTRY[bench]
    for d in loader(data_root, begin, end):
        if d.get("turns") is not None:  # multi-turn text question (MT-bench)
            yield Question(question_id=d["qid"], prompt_inputs={},
                           category=d.get("category", ""), turns=d["turns"])
            continue
        text = d["text"] if d["text"] is not None else CAPTION_TEXT
        parts = [text]
        extra = EXTRA_INSTRUCTION.get(bench)
        if extra:
            parts.append(extra)
        if d.get("frames"):
            inputs = build_video_inputs(processor, parts, d["frames"])
        elif d["image"] is not None:
            messages = _msg(parts, n_images=1)
            inputs = build_inputs(processor, messages, [d["image"]])
        else:
            messages = _msg(parts, n_images=0)
            inputs = build_inputs(processor, messages, [])
        yield Question(question_id=d["qid"], prompt_inputs=inputs,
                       category=d.get("category", ""))


def build_video_inputs(processor, text_parts: List[str], frames) -> Dict[str, Any]:
    """Video prompt: chat template with a video slot + stacked raw frames
    (Qwen targets; reference mvbench/msvd prompt modules)."""
    content = [{"type": "text", "text": t} for t in text_parts]
    content.append({"type": "video"})
    messages = [
        {"role": "system", "content": [{"type": "text", "text": SYSTEM_PROMPT}]},
        {"role": "user", "content": content},
    ]
    prompt = processor.apply_chat_template(messages, add_generation_prompt=True)
    enc = processor(videos=[frames], text=prompt, return_tensors="np")
    arr = np.stack([np.asarray(f, np.float32) / 255.0 for f in frames])
    return {
        "input_ids": np.asarray(enc["input_ids"][0]),
        "pixel_values_videos": arr[..., :3],
    }
