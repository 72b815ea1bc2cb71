"""The training step's share of the cards' bf16 peak: the frozen FLOPs a
sample (the frozen tower's forward once, the rest three times, no
recompute; ``counts/<cell>.json``) times the samples of the traced window,
over the window, 989 TFLOP/s and the cards used, in %."""

from h100_bench.counts.ops import peaks


def read(trace):
    flops = trace.work.get("flops")
    if not flops or trace.window_s <= 0:
        return None
    rate = peaks()["bf16_flops_per_s"] * trace.chips
    return 100.0 * flops / trace.window_s / rate
