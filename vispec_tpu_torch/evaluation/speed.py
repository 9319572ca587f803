"""Speed aggregator: speculative vs baseline speedup + mean acceptance length.

Reference: vispec/evaluation/speed.py:11-97 — sweeps models x datasets x
temperatures x methods, computing  speedup = (spec tokens/s) / (baseline
tokens/s)  from the JSONL records and the mean acceptance length tau.  The
reference re-tokenizes baseline text because its baseline scripts never
incremented new_tokens (speed.py:86-88); our baseline records count correctly,
but a ``retokenize`` hook is provided for byte-compatible aggregation of
reference-produced files.

The PyTorch port's copy of ``vispec_tpu/evaluation/speed.py`` (arithmetic
over the answer files only).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional


def load_records(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def tokens_per_second(
    records: List[dict],
    retokenize: Optional[Callable[[str], int]] = None,
    use_decode_time: bool = False,
) -> float:
    total_tokens = 0
    total_time = 0.0
    for rec in records:
        if retokenize is not None:
            toks = sum(retokenize(t) for t in rec["turns"])
        else:
            toks = sum(rec["new_tokens"])
        total_tokens += toks
        if use_decode_time and "decode_time" in rec:
            total_time += rec["decode_time"]
        else:
            total_time += sum(rec["wall_time"])
    return total_tokens / max(total_time, 1e-9)


def mean_acceptance_length(records: List[dict]) -> float:
    """Mean accepted DRAFT tokens per round — the reference's τ convention.

    The reference records ``int(accept_length)`` per round
    (spec_model_ours.py:509-510) and its aggregator prints the raw mean
    (speed.py:70); each round COMMITS ``accept_length + 1`` tokens (the
    accepted chain + the bonus/root, utils.py:582 ``new_token +=
    accept_length + 1``), so tokens-per-round = τ + 1.  We report both —
    ``tau`` here matches the reference README's τ column (e.g. 2.98 for
    LLaVA-1.6-7B at T=0 means 3.98 committed tokens per round)."""
    accs: List[int] = []
    for rec in records:
        accs.extend(rec.get("acceptance_length", []))
    return sum(accs) / max(len(accs), 1)


def speedup_report(
    spec_file: str,
    baseline_file: str,
    retokenize: Optional[Callable[[str], int]] = None,
    use_decode_time: bool = False,
) -> Dict[str, float]:
    spec = load_records(spec_file)
    base = load_records(baseline_file)
    spec_tps = tokens_per_second(spec, None, use_decode_time)
    base_tps = tokens_per_second(base, retokenize, use_decode_time)
    tau = mean_acceptance_length(spec)
    return {
        "spec_tokens_per_s": spec_tps,
        "baseline_tokens_per_s": base_tps,
        "speedup": spec_tps / max(base_tps, 1e-9),
        "tau": tau,  # reference convention: accepted draft tokens per round
        "tokens_per_round": tau + 1.0,  # committed incl. bonus (utils.py:582)
        "n_spec": len(spec),
        "n_baseline": len(base),
    }


def sweep(
    root: str,
    models: List[str],
    datasets: List[str],
    temperatures: List[float],
    methods: List[str],
    **kwargs,
) -> List[dict]:
    """Directory-layout sweep mirroring speed.py:56-97:
    {root}/{model}/{dataset}/T{temp}/{method}.jsonl vs baseline.jsonl."""
    rows = []
    for m in models:
        for d in datasets:
            for t in temperatures:
                base = os.path.join(root, m, d, f"T{t:g}", "baseline.jsonl")
                if not os.path.exists(base):
                    continue
                for method in methods:
                    spec = os.path.join(root, m, d, f"T{t:g}", f"{method}.jsonl")
                    if not os.path.exists(spec):
                        continue
                    rep = speedup_report(spec, base, **kwargs)
                    rep.update(model=m, dataset=d, temperature=t, method=method)
                    rows.append(rep)
    return rows


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--spec-file", required=True)
    p.add_argument("--baseline-file", required=True)
    p.add_argument("--use-decode-time", action="store_true")
    args = p.parse_args()
    rep = speedup_report(args.spec_file, args.baseline_file,
                         use_decode_time=args.use_decode_time)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
