"""Percentile and window arithmetic over a run's per-request timeline.

Times are host-clock seconds from the window's start.  A request's time to
first token counts from its scheduled arrival (open loop: a stall delays
every request due during it) or from its submission (closed loop: the
client sends when its last request completes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclass
class Timeline:
    """What the window saw of one request."""

    start_s: float  # scheduled arrival (open) or submission (closed)
    first_s: Optional[float] = None  # first streamed token
    last_s: Optional[float] = None  # last streamed token
    tokens: int = 0
    first_tokens: int = 0  # tokens streamed with the first (one chunk's worth)
    done_s: Optional[float] = None  # completion (step() returned it)


def ttft_ms(reqs: List[Timeline]) -> List[float]:
    """Time to first token of every request that has one."""
    return [(r.first_s - r.start_s) * 1e3 for r in reqs if r.first_s is not None]


def tpot_ms(reqs: List[Timeline], close_s: float, start_s: float = -math.inf
            ) -> List[float]:
    """Time per output token after the first: (last - first token) over the
    tokens streamed after the first delivery, of every request completed in
    [start_s, close_s] that streamed more than once.  The engine streams a
    chunk's tokens together, so the first delivery can hold several; they
    took no time after the first token and are not counted."""
    return [(r.last_s - r.first_s) * 1e3 / (r.tokens - r.first_tokens) for r in reqs
            if r.done_s is not None and start_s <= r.done_s <= close_s
            and r.tokens > r.first_tokens]
