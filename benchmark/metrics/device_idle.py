"""Device: the share of the window in which no kernel ran on the card
(profiler trace, NCCL's waits not counted as busy), in percent."""


def read(run):
    t = run.trace
    if t is None or t.lost or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
