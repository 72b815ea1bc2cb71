"""Share of the traced training window that the card idled while the host's
innermost open span was ``psalm::model`` or a ``psalm::model.*`` stage under
it (``PSALM.forward``), in % (``h100_bench/program_spans.py``; top span
``psalm::train.step``)."""

from h100_bench import program_spans


def read(trace):
    return program_spans.idle_share(trace, "train.step", "model", "model.*")
