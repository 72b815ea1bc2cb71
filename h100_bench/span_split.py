"""A traced run of one cell that also writes the program's split of its
window to a JSON file: the card's idle share under each ``psalm::`` span as
the innermost open on the top span's thread, the idle left outside the top
spans, the runtime launches and syncs made under each span, and the span
metrics (``metrics/{eval,train}.idle_*.py`` and the two counts), null where
the program opened none of their spans.

    python3 h100_bench/span_split.py OUT.json --workload eval_panoptic_b8 \\
        --seed 2147484711 --seconds 30 --trace 1

The arguments after OUT.json are ``run.py``'s; its result line and exit code
are kept. The split is taken from the same ``common.Trace`` the declared
metrics read, after the window has closed.
"""

from __future__ import annotations

import json
import runpy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench import common, program_spans  # noqa: E402
# bound before ``main`` wraps the module's name
from h100_bench.common import read_metrics  # noqa: E402

#: each kind of cell's top span and the metrics that read its spans
SPAN_METRICS = {
    "eval": ("runner.infer", [
        "eval.idle_stage", "eval.idle_model", "eval.idle_heads",
        "eval.idle_results", "eval.model_launches_per_image"]),
    "train": ("train.step", [
        "train.idle_stage", "train.idle_forward", "train.idle_criterion",
        "train.idle_matcher", "train.idle_backward", "train.idle_optimizer",
        "train.criterion_syncs_per_step"]),
}


def summary(trace, kind: str) -> dict:
    """The split of a traced window of a cell of ``kind``."""
    top, names = SPAN_METRICS[kind]
    read = read_metrics(names, trace)
    s = program_spans.split(trace, top)
    pct = 100.0 / trace.window_s
    by_span = {n: v * pct for n, v in sorted(s.idle_s.items())}
    idle = 100.0 * (1.0 - trace.busy_s / trace.window_s)
    return {
        "window_s": trace.window_s,
        "work": trace.work,
        "device_idle": idle,
        "metrics": {n: read.get(n) for n in names},
        "idle_by_span": by_span,
        "idle_outside": idle - sum(by_span.values()) if by_span else None,
        "launches_by_span": program_spans.calls_by_span(
            trace, top, common.LAUNCH_CALLS),
        "syncs_by_span": program_spans.calls_by_span(
            trace, top, common.SYNC_CALLS),
        "spans": len(s.spans),
    }


def main(argv) -> None:
    out_path, run_args = argv[0], argv[1:]
    workload = run_args[run_args.index("--workload") + 1]
    kind = common.cell(workload)["traffic"]["kind"]

    def read_and_split(names, trace):
        got = read_metrics(names, trace)
        split = summary(trace, kind)
        with open(out_path, "w") as f:
            json.dump(split, f, indent=1, sort_keys=True)
        return got

    common.read_metrics = read_and_split
    run = common.BENCH_DIR / "run.py"
    sys.argv = [str(run)] + run_args
    runpy.run_path(str(run), run_name="__main__")


if __name__ == "__main__":
    main(sys.argv[1:])
