"""Serving engine (spec/serving.py): 90th percentile of the engine's queue
wait (the program's ``engine.queue`` span: submission to the start of the
request's admission) over the window's requests, in ms; a request still
queued at the window's close counts its wait to the close.  Nothing
without the program's spans."""

from benchmark.lib import spans
from benchmark.lib.stats import percentile


def read(run):
    sp = spans.of(run)
    return None if sp is None else percentile(sp.queue_waits_ms(run.window), 90)
