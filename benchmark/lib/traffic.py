"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed -> the requests of a run.

Every seed gets the same schedule: each size is the distribution's
quantile at (i + 0.5) / n, and their order and the arrival gaps' are drawn
from the mix's ``schedule_seed``; the run's seed draws the token ids, the
pixels and the weights.  So two seeds do the same work, and a run's spread
is the system's, not the draw's.

Mix keys:
  loop: "open" (Poisson arrivals at ``rate_per_s``) or "closed" (``clients``
        that each send the next request when the last one completes)
  prompt.text_tokens, output: a distribution {"dist": "uniform"|"lognormal"
        |"fixed", "min", "max", "median", "sigma", "value"}
  prompt.images: optional [{"size": [h, w], "weight": w}, ...], one image
        a request, sizes drawn in proportion to the weights
  requests_per_client_per_s (closed loop): an upper bound on how fast one
        client can finish requests; it sizes each client's queue
  ramp_s: seconds of traffic before the window opens, so that the window
        sees a steady load (its requests are not the window's)
  schedule_seed: the order of the sizes and of the arrival gaps
  why, sources: what the mix stands for, and the public source each
        distribution is fitted to or that it is assumed (read by no code)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Request:
    """One request as the traffic defines it, before ids and pixels."""

    index: int
    text_tokens: int
    cap: int
    image: Optional[Tuple[int, int]] = None
    arrival_s: float = 0.0  # open loop: scheduled offset from the window start
    client: int = -1  # closed loop: the client that sends it


@dataclass
class Plan:
    loop: str
    requests: List[Request]
    clients: int = 0
    rate_per_s: float = 0.0
    ramp_s: float = 0.0  # the traffic runs this long before the window opens
    queues: List[List[int]] = field(default_factory=list)  # closed loop


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The distribution's values at (i + 0.5) / n, i < n, as integers."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "fixed":
        v = np.full(n, float(spec["value"]))
    elif kind == "uniform":
        v = spec["min"] + (spec["max"] - spec["min"]) * u
    elif kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = spec["median"] * np.exp(spec["sigma"] * z)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    lo, hi = spec.get("min", -math.inf), spec.get("max", math.inf)
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def proportional_counts(weights: List[float], n: int) -> List[int]:
    """Counts that sum to n in proportion to the weights (largest remainder)."""
    w = np.asarray(weights, np.float64)
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def request_count(mix: dict, seconds: float) -> int:
    if mix["loop"] == "open":
        return max(1, int(math.floor(mix["rate_per_s"] * seconds)))
    per_client = int(math.ceil(mix["requests_per_client_per_s"] * seconds)) + 2
    return mix["clients"] * per_client


def plan(mix: dict, seconds: float) -> Plan:
    """The run's requests: sizes from the mix's quantiles in the order its
    ``schedule_seed`` draws; open-loop arrival gaps are exponential
    quantiles scaled to a mean of exactly 1 / rate, so every run sends the
    same n requests in the window."""
    ramp = float(mix.get("ramp_s", 0.0))
    n = request_count(mix, seconds + ramp)
    rng = np.random.default_rng([int(mix["schedule_seed"]), 0x7261])
    text = rng.permutation(quantiles(mix["prompt"]["text_tokens"], n))
    caps = rng.permutation(quantiles(mix["output"], n))
    images: List[Optional[Tuple[int, int]]] = [None] * n
    spec = mix["prompt"].get("images")
    if spec:
        counts = proportional_counts([s["weight"] for s in spec], n)
        sizes = [tuple(s["size"]) for s, c in zip(spec, counts) for _ in range(c)]
        images = [sizes[i] for i in rng.permutation(n)]
    reqs = [Request(i, int(text[i]), int(caps[i]), images[i]) for i in range(n)]
    if mix["loop"] == "open":
        rate = float(mix["rate_per_s"])
        gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n)
        gaps = rng.permutation(gaps / gaps.mean() / rate)
        arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) - ramp
        for r, a in zip(reqs, arrivals):
            r.arrival_s = float(a)
        return Plan("open", reqs, rate_per_s=rate, ramp_s=ramp)
    if mix["loop"] != "closed":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    k = int(mix["clients"])
    queues = [list(range(c, n, k)) for c in range(k)]
    for c, q in enumerate(queues):
        for i in q:
            reqs[i].client = c
    return Plan("closed", reqs, clients=k, queues=queues, ramp_s=ramp)
