"""Kernels (ops/verify_attention.py, csrc/verify_attention.cu): the
roofline seconds of the window's verify-attention calls (the larger of
operations over peak and bytes over bandwidth, each live K/V row read once
per slot and KV head) over the device time of the attention kernels in
the trace, in percent.  Nothing without a sound trace."""


def read(run):
    t = run.trace
    if t is None or t.lost or t.attention_s <= 0:
        return None
    return 100.0 * run.attention_bound_s() / t.attention_s
