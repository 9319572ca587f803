"""Device: the share of the window in which no kernel ran on the card
while the host was inside an admission (the program's ``engine.admit``
spans: preprocessing, the tower, the prefill, the slot's copy), in
percent.  Nothing without a sound trace and the program's spans."""

from benchmark.lib import spans


def read(run):
    return spans.idle_share(run, spans.ADMIT)
