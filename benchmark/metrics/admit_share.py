"""Serving engine (spec/serving.py): the host seconds of mid-flight
admissions (``stats['admit_dispatch_s']``: their dispatch, not their device
time) as a share of the window, in percent."""


def read(run):
    win = run.window
    return 100.0 * sum(s.admit_s for s in run.steps()) / win.window_s if win.window_s else None
