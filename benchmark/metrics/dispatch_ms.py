"""Decode round (spec/batch.py, spec/loop.py): the host's time inside the
program's ``engine.round`` spans (a round's launches queued, no host
read), per round, in ms.  Nothing without the program's spans."""

from benchmark.lib import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    total, rounds = sp.host_s(spans.ROUND)
    return 1e3 * total / rounds if rounds else None
