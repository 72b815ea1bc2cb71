"""Idle share of the card over the traced training window (averaged over the
cards used): 100 x (1 - the union of the profiler's kernel, copy and fill
intervals / the window)."""


def read(trace):
    if trace.window_s <= 0 or not trace.intervals:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
