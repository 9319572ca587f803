"""90th percentile of the time to first token over every request submitted
in the window (from its scheduled arrival in an open loop, from its
submission in a closed one); requests still waiting at the close are
waited for.  The ramp's requests are not the window's."""

from benchmark.lib.stats import percentile, ttft_ms


def read(run):
    return percentile(ttft_ms(run.window.requests), 90)
