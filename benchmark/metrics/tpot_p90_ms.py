"""90th percentile of the time per output token after the first, (last -
first token) / (tokens streamed after the first delivery), over every
request completed in the window."""

from benchmark.lib.stats import percentile, tpot_ms


def read(run):
    win = run.window
    return percentile(tpot_ms(list(win.timelines.values()), win.close_s, win.start_s), 90)
