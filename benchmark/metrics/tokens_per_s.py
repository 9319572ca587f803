"""Output tokens streamed in the window / the window's seconds (host clock)."""


def read(run):
    win = run.window
    return win.tokens_in_window / win.window_s if win.window_s > 0 else None
