"""Device: the share of the window in which no kernel ran on the card
while the host was inside a round's dispatch (the program's
``engine.round`` spans), in percent.  Nothing without a sound trace and
the program's spans."""

from benchmark.lib import spans


def read(run):
    return spans.idle_share(run, spans.ROUND)
