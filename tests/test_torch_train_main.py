"""The port's training command line (``train.py::main``) against psalm_tpu's
Trainer loop on the CPU, tiny config, f32, on tests/test_data_pipeline.py's
synthetic COCO tree with its ``StubTokenizer``.

``main`` runs from a model directory of one ``parity_state_dict`` (its
``psalm_tpu_config.json`` the tiny config), through the prefetching loader
(2 workers), with TensorBoard scalars and a profiler trace: 3 steps that
save at step 2 and keep one checkpoint, then a second ``main`` that resumes
at step 3 and goes on to 5. JAX's ``Trainer.train`` runs the same two
rounds (its own resume) from the same weights on the same batches (the
port's samples, collated by JAX's ``collate``) with the same point draws,
in a Python process of its own (tests/test_torch_train.py says why). The
logged lines agree to 1e-4 relative (f32 sums in another order through
five steps of AdamW; the parameters stay within 0.1 lr of each other, as
tests/test_torch_train.py shows).

JAX's side runs its criterion with one repair, ``ValidOnlyCriterion``: its
``loss_class_name_labels`` scatters every target's label, the padded ones
as background at query 0, so when a real target is matched to query 0 a
padded one's background overwrites its label (the dataset pads to 100
targets). The port, as the reference, scatters the matched targets only
(``ROADMAP.md``, Queue 3, since PR 4;
tests/test_torch_criterion.py::test_class_labels_skip_padding_where_jax_overwrites).
"""

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_data_pipeline import StubTokenizer, _write_synthetic_coco
from test_torch_modules import parity_state_dict
from test_torch_train import point_draws

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.config import config_to_json
from psalm_tpu_torch.train import train as ttrain

B = 2
LOGGED = ("loss_mask", "loss_dice", "loss_SEG_class", "loss_class_name_class",
          "loss_region_class", "loss_llm", "loss", "grad_norm")


def _tree(tmp):
    """The synthetic tree, with its val2017 split also as train2017 (the
    training datasets read the train split)."""
    root, _ = _write_synthetic_coco(tmp)
    for d in ("", "panoptic_"):
        shutil.copytree(os.path.join(root, f"{d}val2017"),
                        os.path.join(root, f"{d}train2017"))
    shutil.copy(os.path.join(root, "annotations/panoptic_val2017.json"),
                os.path.join(root, "annotations/panoptic_train2017.json"))
    return root


def _model_dir(tmp, cfg):
    path = os.path.join(tmp, "model")
    os.makedirs(path)
    sd = jax_to_torch_state_dict(convert_psalm_checkpoint(
        parity_state_dict(cfg, seed=5), cfg), cfg)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "psalm_tpu_config.json"), "w") as f:
        f.write(config_to_json(cfg))
    return path


def _argv(root, model, out, steps, extra=()):
    return ["--output_dir", out, "--model_name_or_path", model,
            "--panoptic_json_path", root, "--per_device_train_batch_size",
            str(B), "--num_train_steps", str(steps), "--save_steps", "2",
            "--save_total_limit", "1", "--logging_steps", "1",
            "--learning_rate", "1e-4", "--warmup_ratio", "0.1",
            "--bf16", "false", "--model_max_length", "512", "--seed", "0",
            *extra]


def _jax_rounds(cfg_json, sd, rounds, draws, out_dir):
    """JAX's Trainer.train over ``rounds`` ((num_train_steps, sample
    batches) each, a fresh Trainer per round as the port's main makes one),
    logging into ``out_dir``; returns its train_log.jsonl lines."""
    from psalm_tpu.config import config_from_json
    from psalm_tpu.data.datasets import collate  # noqa: F401 (the loop's)
    from psalm_tpu.models.psalm import PSALM as JPSALM
    from psalm_tpu.train.criterion import PSALMCriterion as JCriterion
    from psalm_tpu.train.train import Trainer as JTrainer
    from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint as conv

    class ValidOnlyCriterion(JCriterion):
        """JAX's criterion with the padded targets' class scatter dropped
        (out of range: jnp's scatter drops it)."""

        def loss_class_name_labels(self, outputs, targets, src_idx, valid):
            Q = outputs["pred_class_name_logits"].shape[1]
            return super().loss_class_name_labels(
                outputs, targets, jnp.where(valid, src_idx, Q), valid)

    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = config_from_json(cfg_json)
    variables = jax.tree.map(jnp.asarray, conv(sd, cfg))
    model = JPSALM(cfg)

    class Batches:
        """next_batch() hands out the given samples in order."""

        def __init__(self, batches):
            self.batches = iter(batches)

        def next_batch(self):
            return next(self.batches)

    for steps, batches in rounds:
        args = argparse.Namespace(
            output_dir=out_dir, learning_rate=1e-4, warmup_ratio=0.1,
            weight_decay=0.0, num_train_steps=steps,
            per_device_train_batch_size=B, save_steps=2, save_total_limit=1,
            logging_steps=1, gradient_checkpointing=False, bf16=False,
            profile_steps=None, seed=0, dataloader_num_workers=0)
        trainer = JTrainer(args, cfg=cfg, model=model, variables=variables)
        trainer.criterion = ValidOnlyCriterion(
            cfg.loss, cfg.mask_decoder.num_queries,
            uniform_fn=lambda key, shape: draws[tuple(shape)])
        trainer.train(Batches(batches), None)
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def jax_rounds(tmp, *args):
    """``_jax_rounds`` in a fresh Python process."""
    inp, out = os.path.join(tmp, "jax_in.pkl"), os.path.join(tmp, "jax.pkl")
    with open(inp, "wb") as f:
        pickle.dump(args + (os.path.join(tmp, "jax_out"),), f)
    paths = [os.path.dirname(os.path.abspath(__file__)),
             os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    code = (f"import pickle, sys; sys.path[:0] = {paths!r}; "
            "import test_torch_train_main as t; "
            f"a = pickle.load(open({inp!r}, 'rb')); "
            f"pickle.dump(t._jax_rounds(*a), open({out!r}, 'wb'))")
    # about three times the 143 s the process took in a full run of tests/
    # with 6 workers on 8 cores, so that a hang fails inside the run with
    # its stderr
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=450)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:  # written just now by the process above
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    tmp = str(tmp_path_factory.mktemp("main"))
    cfg = tiny_test_config()
    root, model = _tree(tmp), _model_dir(tmp, cfg)
    out = os.path.join(tmp, "out")
    tok = StubTokenizer()
    draws = point_draws(cfg, B)

    class Criterion(ttrain.PSALMCriterion):
        """The criterion with the test's fixed point draws."""

        def __init__(self, *a, **kw):
            kw["uniform_fn"] = lambda gen, shape: torch.from_numpy(
                draws[tuple(shape)])
            super().__init__(*a, **kw)

    monkeypatch_module.setattr(ttrain, "PSALMCriterion", Criterion)
    # the samples main collates (its panoptic dataset shuffles the class
    # names with Python's random), for JAX's loop
    seen = []

    def collate(samples):
        seen.append(samples)
        return real_collate(samples)

    real_collate = ttrain.collate
    monkeypatch_module.setattr(ttrain, "collate", collate)
    extra = ("--device", "cpu", "--dataloader_num_workers", "2",
             "--report_to", "tensorboard", "--profile_steps", "0,1")
    first = ttrain.main(_argv(root, model, out, 3, extra), tokenizer=tok)
    dirs_after_first = sorted(os.listdir(out))
    second = ttrain.main(_argv(root, model, out, 5, extra[:6]), tokenizer=tok)
    with open(os.path.join(out, "train_log.jsonl")) as f:
        lines = [json.loads(line) for line in f]

    assert len(seen) == 5
    sd = torch.load(os.path.join(model, "pytorch_model.bin"))
    want = jax_rounds(tmp, config_to_json(cfg),
                      {k: v.numpy() for k, v in sd.items()},
                      [(3, seen[:3]), (5, seen[3:])], draws)
    return dict(out=out, first=first, second=second, lines=lines, want=want,
                dirs_after_first=dirs_after_first)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_main_logs_what_jax_logs(runs):
    lines, want = runs["lines"], runs["want"]
    assert [l["step"] for l in lines] == [0, 1, 2, 3, 4]
    assert [l["step"] for l in want] == [0, 1, 2, 3, 4]
    for got, w in zip(lines, want):
        assert got["dataset_type"] == w["dataset_type"] == "panoptic_coco"
        for k in LOGGED:
            assert abs(got[k] - w[k]) <= 1e-4 * abs(w[k]), (got["step"], k,
                                                            got[k], w[k])
        assert np.isfinite(got["loss"]) and got["loss"] > 0


def test_main_prunes_checkpoints_and_resumes(runs):
    assert runs["dirs_after_first"] == ["checkpoint-3", "tb",
                                        "trace_steps_0_1.json",
                                        "train_log.jsonl"]
    assert runs["first"].step == 3 and runs["second"].step == 5
    assert runs["second"].optimizer.count == 5
    assert sorted(d for d in os.listdir(runs["out"])
                  if d.startswith("checkpoint-")) == ["checkpoint-5"]


def test_main_tensorboard_scalars_read_back_as_the_log(runs):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(os.path.join(runs["out"], "tb"))
    acc.Reload()
    lines = runs["lines"]  # both runs report, each to a file of its own
    assert len(os.listdir(os.path.join(runs["out"], "tb"))) == 2
    for k in LOGGED + ("step", "steps_per_sec"):
        got = [(e.step, e.value) for e in acc.Scalars(k)]
        assert [s for s, _ in got] == [l["step"] for l in lines], k
        np.testing.assert_allclose([v for _, v in got],
                                   [l[k] for l in lines], rtol=1e-6,
                                   err_msg=k)


def test_main_writes_the_profiler_trace(runs):
    with open(os.path.join(runs["out"], "trace_steps_0_1.json")) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    # the CPU trace of two steps: autograd and the window attention's ops
    assert any("backward" in n.lower() for n in names)
    assert len(trace["traceEvents"]) > 100


def test_report_to_tensorboard_names_a_missing_package(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(ImportError, match="tensorboard package"):
        ttrain.summary_writer("/nonexistent")


def test_main_flags_reach_the_config_unlike_jax_main(tmp_path, monkeypatch):
    """psalm_tpu's main builds PSALMConfig(seg_task=...) and hands it to its
    Trainer, which then skips build_train_config(args): under
    --pixel_decoder_mode dense its model keeps the deformable decoder (and
    the default bf16 compute under --bf16 false). The port's main builds
    the config from the flags (ROADMAP.md, Queue 3)."""
    from psalm_tpu.config import PSALMConfig, SegTask
    from psalm_tpu.train.train import Trainer as JTrainer
    from psalm_tpu.train.train import parse_args as jparse
    flags = ["--output_dir", str(tmp_path / "out"), "--pixel_decoder_mode",
             "dense", "--bf16", "0"]
    jargs = jparse(flags)
    jtrainer = JTrainer(jargs, PSALMConfig(seg_task=SegTask(jargs.seg_task)))
    assert jtrainer.cfg.pixel_decoder.attention_mode == "deformable"
    assert jtrainer.cfg.compute_dtype == "bfloat16"

    seen = {}

    class Capture:
        """Stands in for the Trainer: keeps what main hands it."""

        def __init__(self, args, cfg, model=None, device="cuda", mesh=None):
            seen.update(cfg=cfg, model=model, device=device, mesh=mesh)

        def train(self, sampler):
            seen["sampler"] = sampler

    monkeypatch.setattr(ttrain, "Trainer", Capture)
    root = _tree(str(tmp_path))
    common = ["--panoptic_json_path", root, "--device", "cpu"]
    ttrain.main(flags + common, tokenizer=StubTokenizer())
    pd = seen["cfg"].pixel_decoder
    assert pd.attention_mode == "dense" and pd.transformer_nheads == 2
    assert seen["cfg"].compute_dtype == "float32"
    assert seen["model"] is None and seen["device"] == "cpu"
    assert len(seen["sampler"].datasets) == 1
    # without torchrun's WORLD_SIZE: one process, no mesh, one shard
    assert seen["mesh"] is None and seen["sampler"].num_shards == 1

    # a checkpoint directory: its config under the flags, bf16 compute on
    # f32 parameters
    model = _model_dir(str(tmp_path), tiny_test_config())
    ttrain.main(["--output_dir", str(tmp_path / "out"), "--bf16", "1",
                 "--model_name_or_path", model] + common,
                tokenizer=StubTokenizer())
    assert seen["cfg"].compute_dtype == "bfloat16"
    assert seen["cfg"].phi.hidden_size == tiny_test_config().phi.hidden_size
    assert seen["model"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in seen["model"].parameters())


def test_main_without_a_tokenizer_needs_transformers(monkeypatch, tmp_path):
    """No tokenizer given: main loads one with transformers.AutoTokenizer
    from --model_name_or_path, which raises for a directory without one."""
    with pytest.raises(Exception):
        ttrain.main(["--output_dir", str(tmp_path), "--model_name_or_path",
                     str(tmp_path), "--device", "cpu"])
