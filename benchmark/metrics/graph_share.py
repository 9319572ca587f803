"""Decode round (spec/batch.py, spec/round_graph.py): the share of the
window's rounds (the program's ``engine.round`` spans that start inside
it) replayed from a captured CUDA graph (a ``round.replay`` span inside
the round), in percent.  Nothing without the program's spans, and
nothing from a program that records no replay."""

import numpy as np

from benchmark.lib import spans

REPLAY = "round.replay"


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    inside = (sp.start >= 0.0) & (sp.start < run.window.window_s)
    rounds = inside & (sp.names == spans.ROUND)
    replays = np.nonzero(sp.names == REPLAY)[0]
    if not len(replays) or not rounds.any():
        return None
    parents = sp.parent[replays]
    replayed = np.unique(parents[(parents >= 0)])
    return 100.0 * rounds[replayed].sum() / rounds.sum()
