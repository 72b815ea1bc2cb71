"""The readers of the program's spans (``program_spans.py``,
``metrics/{eval,train}.idle_*.py`` and the two counts) on hand-made traces:
the card's idle time goes to the innermost ``psalm::`` span open on the top
span's thread, a gap is split where a span ends, the shares add up to the
device's idle share less the idle outside the top spans, and a reader whose
span is absent reads nothing."""

import json
from types import SimpleNamespace

import pytest

from h100_bench import common, program_spans, span_split

EVAL = span_split.SPAN_METRICS["eval"][1]
TRAIN = span_split.SPAN_METRICS["train"][1]


def ev(name, start, end=None, thread=1):
    time_range = SimpleNamespace(start=start,
                                 end=start if end is None else end)
    return SimpleNamespace(name=name, thread=thread, time_range=time_range)


def span(name, start, end, thread=1):
    return ev("psalm::" + name, start, end, thread)


def trace(events, busy, window_us, **work):
    intervals = common.merged(busy)
    return SimpleNamespace(cpu_events=events, intervals=intervals,
                           busy_s=sum(b - a for a, b in intervals) / 1e6,
                           window_s=window_us / 1e6, work=work)


def device_idle(t):
    covered = sum(b - a for a, b in t.intervals) / 1e6
    return 100.0 * (1.0 - covered / t.window_s)


def eval_trace(drop=()):
    """One call over a window of 1000 us: stage 0-100, model 100-600 with
    Phi 200-400, heads 600-900, results 900-1000; the card busy 50-150,
    250-350 and 650-700; launches at 120 and 300 (inside the model), 650
    (heads), and on another thread at 300."""
    spans = [span("runner.infer", 0, 1000), span("runner.stage", 0, 100),
             span("model", 100, 600), span("model.phi", 200, 400),
             span("runner.heads", 600, 900), span("runner.results", 900, 1000),
             span("model", 0, 1000, thread=2)]
    spans = [s for s in spans if s.name[len("psalm::"):] not in drop]
    calls = [ev("cudaLaunchKernel", t) for t in (120, 300, 650)]
    calls.append(ev("cudaLaunchKernel", 300, thread=2))
    return trace(spans + calls, [(50, 150), (250, 350), (650, 700)], 1000,
                 images=2)


def test_eval_readers():
    t = eval_trace()
    got = common.read_metrics(EVAL, t)
    want = {"eval.idle_stage": 5.0,     # 0-50
            "eval.idle_model": 35.0,    # 150-200, 350-600 (Phi's 100 us in)
            "eval.idle_heads": 25.0,    # 600-650, 700-900
            "eval.idle_results": 10.0,  # 900-1000
            "eval.model_launches_per_image": 1.0}  # 2 launches, 2 images
    assert got == pytest.approx(want)
    idle = sum(v for k, v in got.items() if "idle" in k)
    assert idle == pytest.approx(device_idle(t))  # the top spans cover it


def test_gap_is_split_at_span_boundaries():
    """The idle stretch 350-650 is Phi's to 400, the model's to 600 and the
    heads' after."""
    s = program_spans.split(eval_trace(), "runner.infer")
    assert s.idle_s["model.phi"] == pytest.approx(100e-6)  # 200-250, 350-400
    assert s.idle_s["model"] == pytest.approx(250e-6)  # 150-200, 400-600
    assert s.idle_s["runner.heads"] == pytest.approx(250e-6)


@pytest.mark.parametrize("absent,silent", [
    ("runner.stage", "eval.idle_stage"),
    ("runner.results", "eval.idle_results"),
    ("runner.heads", "eval.idle_heads")])
def test_absent_span_reads_nothing(absent, silent):
    got = common.read_metrics(EVAL, eval_trace(drop=(absent,)))
    assert silent not in got and len(got) == len(EVAL) - 1


def test_no_top_span_reads_nothing():
    got = common.read_metrics(EVAL, eval_trace(drop=("runner.infer",)))
    assert got == {}


def test_model_family_reads_nothing_without_a_model_span():
    got = common.read_metrics(EVAL, eval_trace(drop=("model", "model.phi")))
    assert "eval.idle_model" not in got
    assert "eval.model_launches_per_image" not in got


def test_program_without_spans_reads_nothing():
    """A program that opens no span (one older than its span helper) gives
    no reading at all, not a zero."""
    t = trace([ev("cudaLaunchKernel", 5)], [(0, 10)], 100, images=1,
              steps=1)
    assert common.read_metrics(EVAL + TRAIN, t) == {}


def train_trace():
    """Two steps over 2000 us with a gap 950-1050 between them (the host
    outside the top span); each step: stage, model (its Swin at the
    start), criterion with the matcher inside, backward, optimizer. Syncs:
    two in the criterion (one in the matcher), one in the backward, one on
    the autograd thread inside the criterion's time."""
    events, busy = [], []
    for base in (0, 1050):
        events += [span("train.step", base, base + 950),
                   span("train.stage", base, base + 50),
                   span("model", base + 50, base + 350),
                   span("model.swin", base + 50, base + 150),
                   span("train.criterion", base + 350, base + 500),
                   span("criterion.match", base + 400, base + 450),
                   span("train.backward", base + 500, base + 800),
                   span("train.optimizer", base + 800, base + 950),
                   ev("cudaStreamSynchronize", base + 420),
                   ev("cudaMemcpy", base + 470),
                   ev("cudaStreamSynchronize", base + 600),
                   ev("cudaStreamSynchronize", base + 430, thread=3)]
        busy += [(base + 100, base + 300), (base + 520, base + 780),
                 (base + 820, base + 900)]
    return trace(events, busy, 2000, steps=2)


def test_train_readers():
    t = train_trace()
    got = common.read_metrics(TRAIN, t)
    want = {"train.idle_stage": 5.0,       # 2 x 50
            "train.idle_forward": 10.0,    # 2 x (50-100 Swin, 300-350)
            "train.idle_criterion": 10.0,  # 2 x (350-400, 450-500)
            "train.idle_matcher": 5.0,     # 2 x 50
            "train.idle_backward": 4.0,    # 2 x (500-520, 780-800)
            "train.idle_optimizer": 7.0,   # 2 x (800-820, 900-950)
            "train.criterion_syncs_per_step": 2.0}
    assert got == pytest.approx(want)
    idle = sum(v for k, v in got.items() if "idle" in k)
    outside = 100.0 * 100 / 2000  # 950-1050, between the steps
    assert idle == pytest.approx(device_idle(t) - outside)


def test_a_span_past_its_parent_is_cut_at_the_parent():
    """A child that ends after the span around it (clocks rounded apart)
    gives no time past the parent's end; the parent's next sibling takes
    it."""
    t = trace([span("train.step", 0, 100), span("train.backward", 0, 60),
               span("train.optimizer", 60, 100),
               span("model.phi", 50, 70)], [], 100, steps=1)
    s = program_spans.split(t, "train.step")
    assert s.idle_s == pytest.approx({"train.backward": 50e-6,
                                      "model.phi": 10e-6,
                                      "train.optimizer": 40e-6})


def test_patterns():
    assert program_spans.matches("model.phi", ["model", "model.*"])
    assert program_spans.matches("model", ["model", "model.*"])
    assert not program_spans.matches("models", ["model", "model.*"])
    assert not program_spans.matches("model.phi", ["model"])


def test_calls_by_innermost_span():
    """The eval call's launches under Phi, the model and the heads (the
    other thread's left out); the training syncs under the matcher, the
    criterion and the backward, and one between the steps outside."""
    got = program_spans.calls_by_span(eval_trace(), "runner.infer",
                                      common.LAUNCH_CALLS)
    assert got == {"model": 1, "model.phi": 1, "runner.heads": 1}
    t = train_trace()
    t.cpu_events.append(ev("cudaDeviceSynchronize", 1000))
    got = program_spans.calls_by_span(t, "train.step", common.SYNC_CALLS)
    assert got == {"criterion.match": 2, "train.criterion": 2,
                   "train.backward": 2, program_spans.OUTSIDE: 1}
    assert program_spans.calls_by_span(t, "runner.infer",
                                       common.SYNC_CALLS) == {}


def test_split_summary():
    """The tool's split: the idle by innermost span adds up to the device's
    idle share with what fell outside the top spans; the cell's span
    metrics beside it."""
    got = span_split.summary(train_trace(), "train")
    assert got["device_idle"] == pytest.approx(device_idle(train_trace()))
    assert got["idle_outside"] == pytest.approx(5.0)  # 950-1050
    assert got["idle_by_span"]["criterion.match"] == pytest.approx(5.0)
    assert got["idle_by_span"]["model.swin"] == pytest.approx(5.0)
    assert got["metrics"]["train.criterion_syncs_per_step"] == 2.0
    assert got["syncs_by_span"]["criterion.match"] == 2
    assert got["spans"] == 16


def test_split_summary_without_spans():
    t = trace([ev("cudaLaunchKernel", 5)], [(0, 10)], 100, images=1)
    got = span_split.summary(t, "eval")
    assert got["metrics"] == dict.fromkeys(EVAL)
    assert got["idle_by_span"] == {} and got["idle_outside"] is None
    assert got["launches_by_span"] == {} and got["spans"] == 0


def test_split_tool_wraps_the_drivers_read(monkeypatch, tmp_path):
    """``span_split.main`` runs ``run.py`` with ``common.read_metrics``
    wrapped: the declared metrics come back as before, and the split is
    written once the window's trace is read."""
    declared = ["eval.device_idle"]

    def fake_run(path, run_name):
        assert path.endswith("run.py") and run_name == "__main__"
        from h100_bench.common import read_metrics  # as drivers/eval.py does
        assert read_metrics(declared, eval_trace()) == pytest.approx(
            {"eval.device_idle": 75.0})

    monkeypatch.setattr(span_split.runpy, "run_path", fake_run)
    monkeypatch.setattr(common, "read_metrics", common.read_metrics)
    monkeypatch.setattr(span_split.sys, "argv", list(span_split.sys.argv))
    out = tmp_path / "split.json"
    span_split.main([str(out), "--workload", "eval_panoptic_b8",
                     "--seed", "1", "--seconds", "1", "--trace", "1"])
    got = json.loads(out.read_text())
    assert got["metrics"]["eval.idle_model"] == pytest.approx(35.0)
    assert got["idle_outside"] == pytest.approx(0.0, abs=1e-9)
