"""Share of the traced training window that the card idled while the host's
innermost open span was ``psalm::train.criterion`` (the criterion's call in
``Trainer._seg_loss_fn``; the matcher's span inside it is
``train.idle_matcher``'s), in % (``h100_bench/program_spans.py``; top span
``psalm::train.step``)."""

from h100_bench import program_spans


def read(trace):
    return program_spans.idle_share(trace, "train.step", "train.criterion")
