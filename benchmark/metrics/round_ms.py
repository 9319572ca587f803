"""Decode round (spec/batch.py, spec/loop.py): the host span of the
window's engine steps less their admissions' dispatch, per dispatched
round, in ms."""


def read(run):
    steps = run.steps()
    rounds = sum(s.rounds for s in steps)
    if not rounds:
        return None
    return 1e3 * sum(s.t1 - s.t0 - s.admit_s for s in steps) / rounds
