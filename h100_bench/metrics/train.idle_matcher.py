"""Share of the traced training window that the card idled while the host's
innermost open span was ``psalm::criterion.match``
(``criterion.hungarian_assign``: scipy's host round trip, or K6 / K7), in %
(``h100_bench/program_spans.py``; top span ``psalm::train.step``)."""

from h100_bench import program_spans


def read(trace):
    return program_spans.idle_share(trace, "train.step", "criterion.match")
