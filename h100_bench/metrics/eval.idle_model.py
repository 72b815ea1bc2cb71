"""Share of the traced eval window that the card idled while the host's
innermost open span was ``psalm::model`` or a ``psalm::model.*`` stage under
it (``PSALM.forward``: Swin, the projector, the splice, Phi, the pixel and
mask decoders), in % (``h100_bench/program_spans.py``; top span
``psalm::runner.infer``)."""

from h100_bench import program_spans


def read(trace):
    return program_spans.idle_share(trace, "runner.infer", "model", "model.*")
