"""Models (models/*.py): the operations the window's forwards needed
(prefills, towers, every live slot's verify and draft rows; top-k experts
only) over the window's seconds times the card's dense bf16 peak, in
percent."""

from benchmark.lib.flops import PEAK_BF16_FLOPS


def read(run):
    win = run.window
    if win.window_s <= 0:
        return None
    return 100.0 * run.window_flops() / (win.window_s * PEAK_BF16_FLOPS)
