"""Runtime calls after which the host waits for the card (stream, device and
event synchronizations, synchronous copies) that the host made inside the
program's span ``psalm::train.criterion`` (the criterion and its matcher) in
the traced training window, per step: the criterion's part of
``train.syncs_per_step`` (``h100_bench/program_spans.py``)."""

from h100_bench import program_spans
from h100_bench.common import SYNC_CALLS


def read(trace):
    return program_spans.calls_per(trace, "train.step", "train.criterion",
                                   SYNC_CALLS, "steps")
