"""The eval step's share of the card's bf16 peak: the frozen forward FLOPs an
image (``counts/<cell>.json``) times the images of the traced window, over
the window and 989 TFLOP/s (``counts/peaks.json``), in %."""

from h100_bench.counts.ops import peaks


def read(trace):
    flops = trace.work.get("flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / peaks()["bf16_flops_per_s"]
