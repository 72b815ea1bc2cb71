"""The program's spans (``psalm_tpu_torch/spans.py``) on the CPU, tiny
config: closed without a profiler (no ``record_function`` opened), and under
``torch.profiler`` the eval call's and the training step's spans, each
nested in the one the table in ``PERF.md`` puts it under, on one thread;
the outputs and the loss the same bits with a profiler running or not."""

import argparse

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from psalm_tpu_torch import spans
from psalm_tpu_torch.config import tiny_test_config
from psalm_tpu_torch.data.datasets import SyntheticPanopticDataset, collate
from psalm_tpu_torch.eval.runner import EvalRunner, synthetic_panoptic_batch
from psalm_tpu_torch.models.psalm import PSALM, init_weights_
from psalm_tpu_torch.train import train as ttrain

K = 4

#: span -> the span it opens inside (None: a top span)
MODEL = {"model.swin": "model", "model.projector": "model",
         "model.splice": "model", "model.phi": "model",
         "model.pixel_decoder": "model", "model.mask_decoder": "model"}
EVAL = {"runner.infer": None, "runner.stage": "runner.infer",
        "model": "runner.infer", "runner.heads": "runner.infer",
        "runner.results": "runner.infer", **MODEL}
TRAIN = {"train.step": None, "train.stage": "train.step",
         "model": "train.step", "train.criterion": "train.step",
         "criterion.match": "train.criterion",
         "train.backward": "train.step", "train.optimizer": "train.step",
         **MODEL}


def _runner():
    cfg = tiny_test_config()
    model = init_weights_(PSALM(cfg, device="cpu"),
                          torch.Generator().manual_seed(0)).eval()
    runner = EvalRunner(model, cfg, num_class_names=K,
                        window_clamp_threshold=None)
    batch = synthetic_panoptic_batch(cfg, 2, K, (48, 64), (30, 40), seed=1)
    return runner, batch


def _trainer():
    args = argparse.Namespace(
        output_dir="", learning_rate=1e-4, warmup_ratio=0.1,
        weight_decay=0.0, num_train_steps=10, per_device_train_batch_size=2,
        save_steps=10 ** 9, save_total_limit=1, logging_steps=1,
        gradient_checkpointing=True, bf16=False, seed=0,
        seg_task="panoptic", pixel_decoder_mode="deformable")
    cfg = tiny_test_config()
    ds = SyntheticPanopticDataset(cfg.image_size, cfg.mask_decoder.num_queries,
                                  K, num_samples=2, num_masks=3,
                                  valid_masks=2)
    return (ttrain.Trainer(args, cfg, device="cpu"),
            collate([ds[0], ds[1]]))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events()
                 if e.name.startswith(spans.PREFIX)]


def _parent(event):
    """The nearest enclosing ``psalm::`` span's name, or None."""
    up = event.cpu_parent
    while up is not None and not up.name.startswith(spans.PREFIX):
        up = up.cpu_parent
    return None if up is None else up.name[len(spans.PREFIX):]


def _check_nesting(events, table):
    names = [e.name[len(spans.PREFIX):] for e in events]
    assert sorted(set(names)) == sorted(table)
    assert len({e.thread for e in events}) == 1
    for e, name in zip(events, names):
        assert _parent(e) == table[name], (name, _parent(e))
    return names


def test_closed_span_opens_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("runner.infer") is spans.span("model")
    with spans.span("model"):
        pass
    runner, batch = _runner()
    runner.infer(batch)
    assert spans.spanned("x")(lambda a, b=1: a + b)(1, b=2) == 3


def test_eval_call_spans():
    runner, batch = _runner()
    runner.infer(batch)  # the first call's one-off work out of the trace
    _, events = _traced(lambda: runner.infer(batch))
    names = _check_nesting(events, EVAL)
    for name in EVAL:  # one of each a call: the heads loop inside one span
        assert names.count(name) == 1, name


def test_train_step_spans():
    trainer, batch = _trainer()
    _, events = _traced(lambda: trainer.step(batch))
    names = _check_nesting(events, TRAIN)
    assert names.count("criterion.match") == 1
    assert names.count("train.step") == names.count("model") == 1


def _flat(result):
    if isinstance(result, dict):
        return [x for k in sorted(result) for x in _flat(result[k])]
    if isinstance(result, list):
        return [x for v in result for x in _flat(v)]
    return [np.asarray(result)]


def test_spans_change_no_bits():
    runner, batch = _runner()
    plain = _flat(runner.infer(batch))
    traced, _ = _traced(lambda: runner.infer(batch))
    assert len(plain) == len(_flat(traced))
    for a, b in zip(plain, _flat(traced)):
        np.testing.assert_array_equal(a, b)

    (t1, batch), (t2, _) = _trainer(), _trainer()
    loss = t1.step(batch)["loss"]
    loss_traced = _traced(lambda: t2.step(batch))[0]["loss"]
    assert torch.equal(loss, loss_traced)
    for (n, p), (_, q) in zip(t1.trainable, t2.trainable):
        assert torch.equal(p, q), n


def test_open_span_is_one_range_of_the_prefixed_name():
    names = sorted(set(EVAL) | set(TRAIN))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            with spans.span(name):
                pass
    assert [e.name for e in prof.events()] == [spans.PREFIX + n for n in names]
