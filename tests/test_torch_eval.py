"""Port vs JAX: the evaluation harness (ROADMAP Queue 1 item 19).

  - every local-layout benchmark loader of the port runs
    ``tests/test_benchmarks.py``'s fabricated trees and assertions, and
    gives the JAX loaders' samples;
  - the chat templates and ``get_conv_template`` equal JAX's;
  - ``run_eval`` on one fabricated checkpoint (single-prompt and
    multi-turn questions, with and without the conversation snapshots,
    spec and baseline): tokens, texts and record keys equal to JAX's;
    ``speed.speedup_report`` of the answer files equal;
  - the ``gen_answer`` CLI, spec and ``--baseline`` (the port's form of
    ``tests/test_gen_answer_cli.py``), and ``--tp 2`` outside a world of two ranks;
  - ``bench_batch.arrival_bench``: every request's tokens equal
    ``specgenerate``'s.
Float32 on the CPU; the JAX runs compile graphs, so the module runs in a
child process (``tests/torch_parity.in_fresh_interpreter``)."""

import json
import sys

import numpy as np
import pytest
import torch

from tests import test_benchmarks
from tests.torch_parity import in_fresh_interpreter
from vispec_tpu.evaluation import benchmarks as jbench
from vispec_tpu.evaluation import harness as jharness
from vispec_tpu.evaluation import speed as jspeed
from vispec_tpu_torch.evaluation import benchmarks as tbench
from vispec_tpu_torch.evaluation import harness as tharness
from vispec_tpu_torch.evaluation import speed as tspeed

pytest.importorskip("safetensors.numpy")

LOADER_TESTS = sorted(n for n in dir(test_benchmarks) if n.startswith("test_load_"))


def _plain(samples):
    """Loader samples with images as arrays (PIL images compare by value)."""
    out = []
    for s in samples:
        d = {}
        for k, v in s.items():
            if hasattr(v, "size") and hasattr(v, "mode"):
                v = np.asarray(v)
            elif isinstance(v, list) and v and hasattr(v[0], "mode"):
                v = [np.asarray(f) for f in v]
            d[k] = v
        out.append(d)
    return out


@in_fresh_interpreter
@pytest.mark.parametrize("name", LOADER_TESTS)
def test_loaders_pass_the_jax_fixtures_and_agree(name, tmp_path, monkeypatch):
    """The JAX test's fabricated tree and checks, run against the port's
    loaders; then the same tree through both registries."""
    calls = {}
    originals = {n: getattr(tbench, n) for n in dir(tbench) if n.startswith("load_")}

    def recording(fn):
        def inner(root, begin, end):
            calls.setdefault(fn.__name__, (root, begin, end))
            return fn(root, begin, end)
        return inner

    for n, fn in originals.items():  # the port's loaders, recording their arguments
        monkeypatch.setattr(tbench, n, recording(fn))
    for key, fn in list(tbench.REGISTRY.items()):
        monkeypatch.setitem(tbench.REGISTRY, key, recording(fn))
    monkeypatch.setattr(test_benchmarks, "B", tbench)
    getattr(test_benchmarks, name)(tmp_path)
    assert calls, name
    for loader, args in calls.items():
        got = _plain(originals[loader](*args))
        want = _plain(getattr(jbench, loader)(*args))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                if isinstance(w[k], np.ndarray):
                    np.testing.assert_array_equal(g[k], w[k])
                elif isinstance(w[k], list) and w[k] and isinstance(w[k][0], np.ndarray):
                    for a, b in zip(g[k], w[k]):
                        np.testing.assert_array_equal(a, b)
                else:
                    assert g[k] == w[k], (loader, k)


@in_fresh_interpreter
def test_templates_and_vendored_questions_match_jax():
    turns, answers = ["q1", "q2"], ["a1"]
    for name in ("vicuna", "qwen", "llama3"):
        assert tharness.CONV_TEMPLATES[name][0](turns, answers) == \
            jharness.CONV_TEMPLATES[name][0](turns, answers)
        assert tharness.CONV_TEMPLATES[name][1] == jharness.CONV_TEMPLATES[name][1]
    for path in ("lmsys/vicuna-7b-v1.5", "Qwen/Qwen2.5-VL-7B-Instruct",
                 "meta-llama/Meta-Llama-3-8B-Instruct", "llava-hf/llava-1.5-7b-hf"):
        assert tharness.get_conv_template(path) == jharness.get_conv_template(path)
    # the vendored MT-bench copy: the port reads its own file, equal to JAX's
    got = list(tbench.load_vicuna("/nonexistent", 0, 100))
    assert got == list(jbench.load_vicuna("/nonexistent", 0, 100))
    assert len(got) == 80 and all(len(q["turns"]) == 2 for q in got)
    qs = list(tbench.iter_questions("vicuna", None, "/nonexistent", 0, 2))
    assert [q.turns for q in qs] == [q["turns"] for q in got[:2]]


class _Tok:
    """A composing per-character tokenizer (tests/test_conversation_snapshot.py)."""

    special_tokens_map = {"eos_token": "</s>"}

    def __call__(self, text):
        class R:
            pass

        r = R()
        r.input_ids = [10 + (ord(c) % 100) for c in text]
        return r

    def decode(self, ids, **kw):
        return "".join(chr(65 + (int(t) % 26)) for t in ids)


def _models(tmp_path):
    import jax.numpy as jnp

    from tests.test_from_pretrained import write_draft_ckpt, write_llama_ckpt
    from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
    from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

    tdir, ddir = str(tmp_path / "t"), str(tmp_path / "d")
    write_llama_ckpt(tdir)
    write_draft_ckpt(ddir)
    kw = dict(total_token=12, depth=3, top_k=4, max_len=512)
    jm = JSpecModel.from_pretrained(tdir, ddir, dtype=jnp.float32, **kw)
    tm = TSpecModel.from_pretrained(tdir, ddir, dtype=torch.float32, device="cpu", **kw)
    return jm, tm, tdir, ddir


def _questions(mod):
    qs = [mod.Question(question_id=i, prompt_inputs={"input_ids": list(range(20 + i, 50 + i))})
          for i in range(2)]
    qs.append(mod.Question(question_id=7, prompt_inputs={}, category="writing",
                           turns=["hello there", "again more"]))
    return qs


@in_fresh_interpreter
def test_run_eval_records_and_speedup_match_jax(tmp_path):
    jm, tm, _, _ = _models(tmp_path)
    runs = {}
    for side, mod, model in (("jax", jharness, jm), ("port", tharness, tm)):
        for mode in ("spec", "snap", "base"):
            path = str(tmp_path / side / f"{mode}.jsonl")
            runs[side, mode] = (path, mod.run_eval(
                model, _questions(mod), path, baseline=mode == "base", max_new_tokens=12,
                num_warmup=1, tokenizer=_Tok(), prefix_cache=mode == "snap"))
    for mode in ("spec", "snap", "base"):
        want, got = runs["jax", mode][1], runs["port", mode][1]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in ("question_id", "category", "turns", "idxs", "new_tokens",
                      "acceptance_length"):
                assert g[k] == w[k], (mode, k)
            assert len(g["wall_time"]) == len(w["wall_time"])
            assert all(t > 0 for t in g["wall_time"])
    # the snapshot continuation answers as the full prefill does
    assert [r["turns"] for r in runs["port", "spec"][1]] == \
        [r["turns"] for r in runs["port", "snap"][1]]
    # the aggregator: the port's == JAX's on the same files
    spec, base = runs["port", "spec"][0], runs["port", "base"][0]
    for use_dt in (False, True):
        assert tspeed.speedup_report(spec, base, use_decode_time=use_dt) == \
            jspeed.speedup_report(spec, base, use_decode_time=use_dt)
    rep = tspeed.speedup_report(spec, base)
    assert np.isfinite(rep["speedup"]) and rep["n_spec"] == rep["n_baseline"] == 3


@in_fresh_interpreter
def test_gen_answer_cli_spec_and_baseline(tmp_path, monkeypatch):
    pytest.importorskip("tokenizers")
    from tests.test_from_pretrained import write_draft_ckpt, write_llama_ckpt
    from tests.test_gen_answer_cli import _write_tokenizer
    from vispec_tpu_torch.evaluation import gen_answer

    tdir, ddir = str(tmp_path / "t"), str(tmp_path / "d")
    write_llama_ckpt(tdir)
    write_draft_ckpt(ddir)
    _write_tokenizer(tdir)
    bench_dir = tmp_path / "data" / "mt_bench"
    bench_dir.mkdir(parents=True)
    with open(bench_dir / "question.jsonl", "w") as f:
        f.write(json.dumps({"question_id": 81, "category": "writing",
                            "turns": ["write a story about robots", "make it shorter"]}) + "\n")

    def run(extra):
        monkeypatch.setattr(sys, "argv", [
            "gen_answer", "--bench", "vicuna", "--model", tdir, "--spec-model", ddir,
            "--data-root", str(tmp_path / "data"), "--total-token", "12", "--depth", "3",
            "--top-k", "4", "--max-len", "512", "--max-new-tokens", "12",
            "--device", "cpu"] + extra)
        gen_answer.main()

    spec_file, base_file = str(tmp_path / "out" / "spec.jsonl"), str(tmp_path / "out" / "b.jsonl")
    run(["--answer-file", spec_file])
    run(["--answer-file", base_file, "--baseline"])
    recs = {}
    for path in (spec_file, base_file):
        recs[path] = [json.loads(line) for line in open(path) if line.strip()]
        assert len(recs[path]) == 1
        r = recs[path][0]
        assert r["question_id"] == 81 and len(r["turns"]) == 2
        assert len(r["new_tokens"]) == 2 and len(r["wall_time"]) == 2
    assert recs[spec_file][0]["turns"] == recs[base_file][0]["turns"]
    report = tspeed.speedup_report(spec_file, base_file)
    assert np.isfinite(report["speedup"]) and report["speedup"] > 0

    # a mesh flag needs a world of that many ranks (torchrun): in one
    # process it is a usage error (tests/test_torch_parallel.py runs --tp 2)
    for flag in ("--tp", "--pp", "--sp"):
        with pytest.raises(SystemExit):
            run(["--answer-file", str(tmp_path / "x.jsonl"), flag, "2"])


@in_fresh_interpreter
def test_arrival_bench_tokens_equal_specgenerate(tmp_path):
    from tests.test_from_pretrained import V
    from vispec_tpu_torch.evaluation.bench_batch import arrival_bench

    _, tm, _, _ = _models(tmp_path)
    tm.eos_token_id = 10**6  # every request runs its whole budget
    row = arrival_bench(tm, b=2, new_tokens=8, rate=50.0, n_requests=5, seed=3, vocab=V)
    assert row["n_requests"] == 5 and row["batch"] == 2 and row["admissions"] >= 1
    assert 0 <= row["latency_p50_s"] <= row["latency_p90_s"] <= row["latency_p99_s"]
    rng = np.random.default_rng(3)  # arrival_bench's prompts
    prompts = [rng.integers(10, V - 10, 100).tolist() for _ in range(5)]
    for ids, toks in zip(prompts, row["tokens"]):
        ref = tm.specgenerate(ids, max_new_tokens=8)
        assert len(toks) == 8  # the engine caps at the budget; a round may commit past it
        assert toks == ref.sequences[len(ids):len(ids) + 8].tolist()
