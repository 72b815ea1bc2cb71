"""Runtime calls that put work on the card (kernel launches, async copies and
fills, graph launches) that the host made inside the program's span
``psalm::model`` (``PSALM.forward``, at any depth under it) in the traced eval
window, per image: the part of ``eval.launches_per_image`` that a captured
forward would take away (``h100_bench/program_spans.py``)."""

from h100_bench import program_spans
from h100_bench.common import LAUNCH_CALLS


def read(trace):
    return program_spans.calls_per(trace, "runner.infer", "model",
                                   LAUNCH_CALLS, "images")
