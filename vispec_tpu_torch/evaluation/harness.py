"""Generic evaluation harness: timed speculative / baseline generation + JSONL.

Distills the common skeleton of the reference's 15 `gen_spec_answer_*.py` and
14 `gen_baseline_answer_*.py` scripts (SURVEY.md §2.3; richest example
gen_spec_answer_sqa.py): dataset iteration -> 3 warmup generations -> per-
question timed `specgenerate(log=True, return_acceptance_len=True,
return_decode_time=True)` -> JSONL records with
turns/idxs/new_tokens/wall_time/acceptance_length/decode_time -> answer-file
dedup (`reorg_answer_file`, :328-339).

Benchmarks plug in as (question iterator, prompt builder) pairs — see
evaluation/benchmarks.py.  Scale-out is process-level (the reference used ray
sharding over GPU groups, :89-122): run N independent processes with
--question-begin/--question-end splits; no collectives needed.

The PyTorch port's copy of ``vispec_tpu/evaluation/harness.py``.  A
generation's ``wall_time`` closes on the device: the generated ids are on
the host (``GenerationResult.sequences``) and the device is synchronized
before the second clock read, so no queued work escapes the interval.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch


@dataclass
class Question:
    question_id: Any
    prompt_inputs: Dict[str, Any]  # kwargs for SpecModel.specgenerate
    category: str = ""
    # multi-turn text questions (MT-bench): raw user turns; the harness carries
    # the conversation across turns (gen_spec_answer_vicuna.py:160-275)
    turns: Optional[List[str]] = None


VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)


def vicuna_prompt(user_turns: List[str], answers: List[str]) -> str:
    """fastchat vicuna_v1.1 template (ADD_COLON_TWO: sep=' ', sep2='</s>'):
    ``{system} USER: {q} ASSISTANT: {a}</s>USER: {q2} ASSISTANT:``"""
    ret = VICUNA_SYSTEM + " "
    for j, q in enumerate(user_turns):
        ret += f"USER: {q} ASSISTANT:"
        if j < len(answers):
            ret += f" {answers[j]}</s>"
    return ret


def qwen_prompt(user_turns: List[str], answers: List[str]) -> str:
    """Qwen ChatML template (fastchat's qwen template; what the reference's
    fastchat ``get_conversation_template(model_id)`` resolves for Qwen targets,
    gen_spec_answer_vicuna.py:16-17)."""
    ret = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    for j, q in enumerate(user_turns):
        ret += f"<|im_start|>user\n{q}<|im_end|>\n<|im_start|>assistant\n"
        if j < len(answers):
            ret += f"{answers[j]}<|im_end|>\n"
    return ret


def llama3_prompt(user_turns: List[str], answers: List[str]) -> str:
    """Llama-3 chat template (the reference's is_llama3 targets stop on
    <|eot_id|>, spec_model_ours.py:268-269)."""
    ret = ("<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
           f"{VICUNA_SYSTEM}<|eot_id|>")
    for j, q in enumerate(user_turns):
        ret += (f"<|start_header_id|>user<|end_header_id|>\n\n{q}<|eot_id|>"
                "<|start_header_id|>assistant<|end_header_id|>\n\n")
        if j < len(answers):
            ret += f"{answers[j]}<|eot_id|>"
    return ret


# name -> (render fn, stop string).  The reference resolves templates per
# model id via fastchat (gen_spec_answer_vicuna.py:16-17, 160-275); running
# MT-bench against a Qwen target with the vicuna template would make the tau
# comparison vs BASELINE.md's Qwen rows invalid (round-2 VERDICT missing #2).
CONV_TEMPLATES = {
    "vicuna": (vicuna_prompt, "</s>"),
    "qwen": (qwen_prompt, "<|im_end|>"),
    "llama3": (llama3_prompt, "<|eot_id|>"),
}


def get_conv_template(model_path_or_id: str) -> str:
    """Template name for a model path/id, by the same substring matching
    fastchat's get_conversation_template applies."""
    name = os.path.basename(str(model_path_or_id).rstrip("/")).lower()
    if "qwen" in name:
        return "qwen"
    if "llama-3" in name or "llama3" in name:
        return "llama3"
    return "vicuna"  # vicuna / llava backbones


def _wall_clock_end(t0: float) -> float:
    """Seconds since ``t0`` once every queued device operation is done."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _clean_output(text: str, special_tokens: List[str],
                  stop_str: str = "</s>") -> str:
    """Stop-string + special-token cleanup (gen_spec_answer_vicuna.py:183-202)."""
    if stop_str in text and text.find(stop_str) > 0:
        text = text[: text.find(stop_str)]
    for tok in special_tokens:
        text = text.replace(tok, "")
    return text.strip()


def _run_multiturn(
    generate, q: Question, tokenizer, temperature: float,
    max_new_tokens: int, seed: int, conv_template: str = "vicuna",
    gen_kwargs: Optional[Dict[str, Any]] = None,
    prefix_cache_model=None,
) -> dict:
    """One MT-bench question: decode every turn, carrying the conversation
    (reference gen_spec_answer_vicuna.py:160-275).

    With ``prefix_cache_model`` set (the SpecModel, spec path only), each turn
    records a ConversationSnapshot and the next turn continues from it, so
    turn k+1 prefills only the template glue + new question instead of the
    whole conversation — a capability the reference lacks (it re-prefills
    every turn).  Tokenization must compose (the re-tokenized conversation
    must extend the committed ids) or the turn silently falls back to a full
    prefill inside specgenerate."""
    render, stop_str = CONV_TEMPLATES[conv_template]
    specials: List[str] = []
    for v in tokenizer.special_tokens_map.values():
        specials.extend(v if isinstance(v, list) else [v])
    answers: List[str] = []
    turns, idxs, new_tokens, wall_time, acc = [], [], [], [], []
    decode_time = 0.0
    for j in range(len(q.turns)):
        prompt = render(q.turns[: j + 1], answers)
        input_ids = tokenizer(prompt).input_ids
        t0 = time.perf_counter()
        snap_kw = {}
        if prefix_cache_model is not None:
            snap_kw = dict(
                keep_hiddens=True,
                continue_from=prefix_cache_model.last_snapshot if j else None,
            )
        res = generate(
            input_ids=input_ids, temperature=temperature,
            max_new_tokens=max_new_tokens, seed=seed, **(gen_kwargs or {}),
            **snap_kw,
        )
        wall = _wall_clock_end(t0)
        out_ids = np.asarray(res.sequences)[len(input_ids):]
        text = _clean_output(
            tokenizer.decode(out_ids, spaces_between_special_tokens=False),
            specials, stop_str,
        )
        answers.append(text)
        turns.append(text)
        idxs.append(int(res.rounds))
        new_tokens.append(int(res.new_tokens))
        wall_time.append(wall)
        acc.extend(res.acceptance_lengths)
        decode_time += res.decode_time
    return {
        "turns": turns, "idxs": idxs, "new_tokens": new_tokens,
        "wall_time": wall_time, "acceptance_length": acc,
        "decode_time": decode_time,
    }


def run_eval(
    model,
    questions: Iterable[Question],
    answer_file: Optional[str],  # None: write nothing (a mesh rank other than 0)
    *,
    baseline: bool = False,
    temperature: float = 0.0,
    max_new_tokens: int = 512,
    num_warmup: int = 3,
    decode_fn: Optional[Callable[[np.ndarray], str]] = None,
    model_id: str = "vispec-tpu",
    seed_base: int = 0,
    tokenizer=None,
    conv_template: str = "vicuna",
    gen_kwargs: Optional[Dict[str, Any]] = None,  # extra specgenerate/
    # ar_generate kwargs (e.g. repetition_penalty)
    prefix_cache: bool = False,  # multi-turn: continue each turn from the
    # previous turn's ConversationSnapshot (spec path only)
) -> List[dict]:
    """Generate answers for all questions; returns the records written.

    ``model`` is a spec.spec_model.SpecModel.  ``decode_fn`` turns generated
    token ids into text (tokenizer.decode); identity repr if None.
    ``tokenizer`` is required for multi-turn questions (Question.turns set):
    the harness re-tokenizes the growing conversation per turn.
    ``conv_template`` picks the chat format for multi-turn questions
    (CONV_TEMPLATES; resolve from the model path with get_conv_template).
    """
    questions = list(questions)
    if answer_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(answer_file)), exist_ok=True)

    generate = model.ar_generate if baseline else model.specgenerate

    def answer(q: Question, seed: int) -> dict:
        if q.turns is not None:
            if tokenizer is None:
                raise ValueError("multi-turn questions need a tokenizer")
            return _run_multiturn(
                generate, q, tokenizer, temperature, max_new_tokens, seed,
                conv_template, gen_kwargs,
                prefix_cache_model=(model if prefix_cache and not baseline
                                    else None),
            )
        t0 = time.perf_counter()
        res = generate(
            temperature=temperature, max_new_tokens=max_new_tokens,
            seed=seed, **q.prompt_inputs, **(gen_kwargs or {}),
        )
        wall = _wall_clock_end(t0)
        prompt_len = len(q.prompt_inputs["input_ids"])
        out_ids = np.asarray(res.sequences)[prompt_len:]
        text = decode_fn(out_ids) if decode_fn else repr(out_ids.tolist())
        return {
            "turns": [text],
            "idxs": [int(res.rounds)],
            "new_tokens": [int(res.new_tokens)],
            "wall_time": [wall],
            "acceptance_length": res.acceptance_lengths,
            "decode_time": res.decode_time,
        }

    # warmup: compile all bucket shapes (gen_spec_answer_sqa.py:203-248)
    for q in questions[:num_warmup]:
        answer(q, seed_base)

    records = []
    with (open(answer_file, "a") if answer_file is not None
          else contextlib.nullcontext()) as fout:
        for i, q in enumerate(questions):
            rec = {
                "question_id": q.question_id,
                "model_id": model_id,
                "category": q.category,
                **answer(q, seed_base + i),
                "tstamp": time.time(),
            }
            records.append(rec)
            if fout is not None:
                fout.write(json.dumps(rec) + "\n")
                fout.flush()
    if answer_file is not None:
        reorg_answer_file(answer_file)
    return records


def reorg_answer_file(answer_file: str) -> None:
    """De-duplicate by question_id keeping the last answer, sort
    (gen_spec_answer_sqa.py:328-339)."""
    answers = {}
    with open(answer_file) as fin:
        for line in fin:
            if line.strip():
                rec = json.loads(line)
                answers[str(rec["question_id"])] = line
    with open(answer_file, "w") as fout:
        for qid in sorted(answers):
            fout.write(answers[qid])
