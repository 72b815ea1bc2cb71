"""Share of the traced eval window that the card idled while the host's
innermost open span was ``psalm::runner.results``
(``EvalRunner._infer_rows``: the copies to the host and the crop to each
original size), in % (``h100_bench/program_spans.py``; top span
``psalm::runner.infer``)."""

from h100_bench import program_spans


def read(trace):
    return program_spans.idle_share(trace, "runner.infer", "runner.results")
