"""Whether the timed path's answers are right: a sample of the requests the
window served, drawn from the seed with the longest among them, each
prompt and its served tokens run once through the configuration's plain
reference.  Per served token, its gap is how far the reference's logit of
it lies below the reference's best at its position.  A cell compares the
widest gap of any sampled token (``widest_logit_gap``) and/or the largest
of the sampled requests' median gaps (``worst_median_logit_gap``), each
against the limit its cell file gives.

The reference runs after the program's state is freed and its peak read,
on weights made again from the seed, so it takes nothing the program made.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


GAP_NUMBERS = ("widest_logit_gap", "worst_median_logit_gap")


@dataclass
class Verdict:
    correct: bool
    numbers: Dict[str, dict] = field(default_factory=dict)  # name -> value, limit, rule
    sample: List[int] = field(default_factory=list)  # input indices checked
    gaps: Dict[int, float] = field(default_factory=dict)  # index -> widest gap
    seconds: float = 0.0  # the reference's time
    positions: Dict[int, np.ndarray] = field(default_factory=dict)  # every gap
    control_positions: Dict[int, np.ndarray] = field(default_factory=dict)
    control_verdict: Optional["Verdict"] = None  # the control under the same limits

    def lines(self) -> List[str]:
        return [f"check {k} {v['value']} limit {v['rule']} {v['limit']}"
                for k, v in self.numbers.items()]

    def hold(self, name: str, value, rule: str, limit) -> None:
        ok = value <= limit if rule == "<=" else value >= limit
        self.numbers[name] = {"value": value, "limit": limit, "rule": rule}
        self.correct &= bool(ok)


def gap_numbers(positions: Dict[int, np.ndarray]) -> Dict[str, float]:
    """The numbers a cell may compare, over every sampled request's gaps:
    the widest gap of any token, and the largest of the requests' median
    gaps, which one wrong request moves however many sound ones beside it."""
    if not positions:
        return {k: float("inf") for k in GAP_NUMBERS}
    return {"widest_logit_gap": max(float(np.max(g)) for g in positions.values()),
            "worst_median_logit_gap": max(float(np.median(g)) for g in positions.values())}


def choose_sample(served: Dict[int, np.ndarray], seed: int, n: int) -> List[int]:
    """Input indices to check: the one with the most served tokens, then
    others drawn from the seed."""
    done = sorted(i for i, toks in served.items() if len(toks))
    if not done:
        return []
    longest = max(done, key=lambda i: (len(served[i]), -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = list(rng.permutation(rest)[: max(0, n - 1)])
    return [longest] + [int(i) for i in pick]


def judge(ref_module, cfg: dict, weights: dict, inputs, served: Dict[int, np.ndarray],
          sample: List[int], limits: dict, errors: int, failure: Optional[str],
          eos: int, control=None) -> Verdict:
    """Run the reference over the sample and hold every number to its limit;
    ``control`` ("fp8") also reads the control's gaps over the same prompts
    and tokens and holds them to the same limits in ``control_verdict``."""
    v = Verdict(correct=True, sample=sample)
    tokens = 0
    short = 0
    for i in sample:
        toks = np.asarray(served[i], np.int64)
        inp = inputs[i]
        tokens += len(toks)
        if len(toks) < inp.cap and (len(toks) == 0 or toks[-1] != eos):
            short += 1
        if len(toks) == 0:
            continue
        gaps, ctrl = ref_module.gaps(cfg, weights, inp, toks, control=control)
        v.gaps[i] = float(np.max(gaps))
        v.positions[i] = gaps
        if ctrl is not None:
            v.control_positions[i] = ctrl

    v.hold("window_failed", int(failure is not None), "<=", 0)
    v.hold("request_errors", int(errors), "<=", 0)
    v.hold("served_tokens_checked", int(tokens), ">=", int(limits["min_served_tokens"]))
    v.hold("short_answers", int(short), "<=", 0)
    compared = [k for k in GAP_NUMBERS if k in limits]
    if not compared:
        raise ValueError(f"a cell's check compares one of {GAP_NUMBERS}")
    mine = gap_numbers(v.positions)
    for key in compared:
        v.hold(key, mine[key], "<=", float(limits[key]))
    if control:
        # the control in the program's place: its first choices' gaps over
        # the same prompts and tokens, held to the same limits
        v.control_verdict = Verdict(correct=True, sample=sample,
                                    positions=v.control_positions)
        theirs = gap_numbers(v.control_positions)
        for key in compared:
            v.control_verdict.hold(key, theirs[key], "<=", float(limits[key]))
    return v
