"""The forward's shape-only constants (``models/layers.py::device_constant``)
on the CPU, at the tiny config and at the published shapes: each entry holds
the output of the function that builds it, bit for bit; a warm eval forward
and a warm training step (gradient checkpointing on) add no miss, call no
table function and give a cold cache's outputs, loss and gradients bit for
bit; an entry first made under ``torch.inference_mode()`` serves a later
backward; entries never change and never require grad; the LRU keeps to its
size. On a card (marked ``gpu``; ``python3 -m pytest --noconftest -m gpu
tests/test_torch_constants.py``): a warm forward copies nothing from the
host and synchronizes no stream inside the model's spans."""

import argparse
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from psalm_tpu_torch import spans
from psalm_tpu_torch.config import tiny_test_config
from psalm_tpu_torch.data.datasets import SyntheticPanopticDataset, collate
from psalm_tpu_torch.eval.runner import EvalRunner, synthetic_panoptic_batch
from psalm_tpu_torch.models import layers, pixel_decoder, psalm, swin
from psalm_tpu_torch.models.psalm import PSALM, init_weights_
from psalm_tpu_torch.ops import msdeform, sampling
from psalm_tpu_torch.train import train as ttrain

K = 4
#: the published model's encoder levels at 1024^2 (res5, res4, res3)
PUBLISHED_LEVELS = ((32, 32), (64, 64), (128, 128))
TINY_LEVELS = ((2, 2), (4, 4), (8, 8))
#: (module, name) of every table function the cache calls on a miss
TABLE_FUNCTIONS = ((layers, "position_embedding_sine"),
            (pixel_decoder, "reference_points"), (msdeform, "reference_grid"),
            (sampling, "resize_weights"), (swin, "shift_attn_mask"))


@pytest.fixture
def cache(monkeypatch):
    """An empty cache of the port's size in place of the port's one."""
    fresh = layers.ConstantCache(layers._CONSTANTS.size)
    monkeypatch.setattr(layers, "_CONSTANTS", fresh)
    return fresh


def _count_table_calls(monkeypatch) -> collections.Counter:
    calls = collections.Counter()
    for mod, name in TABLE_FUNCTIONS:
        def counted(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _refuse():
    raise AssertionError("the entry should be in the cache")


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("hw, npf", [((32, 32), 128), ((64, 64), 128),
                                     ((128, 128), 128), ((2, 2), 16),
                                     ((8, 8), 16), ((3, 5), 16)])
def test_sine_table_is_its_functions_output(cache, hw, npf):
    got = layers.sine_table(*hw, npf, "cpu")
    assert _equal(got, layers.position_embedding_sine(*hw, npf))
    assert layers.sine_table(*hw, npf, "cpu") is got
    assert cache.info() == (1, 1, 1)


@pytest.mark.parametrize("levels", [PUBLISHED_LEVELS, TINY_LEVELS])
def test_encoder_constants_are_their_functions_output(cache, levels):
    ref, norm, grid = pixel_decoder.encoder_constants(levels, True, "cpu")
    assert _equal(ref, torch.from_numpy(pixel_decoder.reference_points(levels)))
    assert _equal(grid, torch.from_numpy(msdeform.reference_grid(levels)))
    assert _equal(norm, torch.tensor([[w, h] for h, w in levels],
                                     dtype=torch.float32))
    again = pixel_decoder.encoder_constants(list(levels), False, "cpu")
    assert again[0] is ref and again[1] is norm and again[2] is None
    assert cache.info() == (2, 3, 3)


@pytest.mark.parametrize("n_in, n_out", [(256, 32), (256, 64), (256, 128),
                                         (128, 256), (16, 4), (8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_weights_are_their_functions_output(cache, n_in, n_out, dtype):
    x = torch.randn(2, n_in, n_in, 1, generator=torch.Generator()
                    .manual_seed(n_in + n_out)).to(dtype)
    got = sampling.resize_bilinear(x, (n_out, n_out))
    w = sampling.resize_weights(n_in, n_out).to(dtype)
    want = torch.einsum("...hwc,wo->...hoc",
                        torch.einsum("...hwc,ho->...owc", x, w), w)
    assert _equal(got, want)
    entry = layers.device_constant(("resize_weights", n_in, n_out, dtype),
                                   _refuse, "cpu")
    assert _equal(entry, w)
    assert cache.info() == (2, 1, 1)  # both axes share the entry


def test_shift_mask_and_pixel_statistics_are_their_functions_output(cache):
    tower = PSALM(tiny_test_config(), device="cpu").model.vision_tower
    ws = tower.cfg.window_size
    for hp in (8, 12, 36):
        assert _equal(tower._shift_mask(hp, hp, torch.device("cpu")),
                      torch.from_numpy(swin.shift_attn_mask(hp, hp, ws,
                                                            ws // 2)))
    model = init_weights_(PSALM(tiny_test_config(), device="cpu"),
                          torch.Generator().manual_seed(0)).eval()
    images = torch.randint(0, 256, (1, 64, 64, 3), dtype=torch.uint8)
    model.encode_images(images)
    for key, values in ((("pixel_mean",), psalm.PIXEL_MEAN),
                        (("pixel_std",), psalm.PIXEL_STD)):
        assert _equal(layers.device_constant(key, _refuse, "cpu"),
                      torch.tensor(values))


def test_attention_bias_is_the_parents():
    """The mask decoder's bias: -1e9 where blocked, +0.0 elsewhere, f32, as
    ``torch.where`` on a -1e9 and a 0 tensor gives it."""
    cfg = tiny_test_config()
    dec = init_weights_(PSALM(cfg, device="cpu"),
                        torch.Generator().manual_seed(0)).predictor
    gen = torch.Generator().manual_seed(3)
    Q, D = cfg.mask_decoder.num_queries, cfg.mask_decoder.hidden_dim
    out = torch.randn(2, Q, D, generator=gen)
    feats = torch.randn(2, 16, 16, cfg.mask_decoder.mask_dim, generator=gen)
    *_, masks, _, bias = dec._prediction_heads(out, feats, (4, 4), None, None,
                                               None, None, None)
    m = sampling.resize_bilinear(masks.float().reshape(2 * Q, 16, 16, 1),
                                 (4, 4)).reshape(2, Q, 16)
    blocked = torch.sigmoid(m) < 0.5
    blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
    want = torch.where(blocked, torch.tensor(-1e9), torch.zeros(()))[:, None]
    assert blocked.any() and (~blocked).any()
    assert _equal(bias, want)
    assert not torch.signbit(bias[bias == 0]).any()


def _runner():
    cfg = tiny_test_config()
    model = init_weights_(PSALM(cfg, device="cpu"),
                          torch.Generator().manual_seed(0)).eval()
    runner = EvalRunner(model, cfg, num_class_names=K,
                        window_clamp_threshold=None)
    batch = synthetic_panoptic_batch(cfg, 2, K, (48, 64), (30, 40), seed=1)
    return runner, runner.stage(batch)


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


def _flat(result):
    if isinstance(result, dict):
        return [x for k in sorted(result) for x in _flat(result[k])]
    if isinstance(result, (list, tuple)):
        return [x for v in result for x in _flat(v)]
    return [] if result is None else [result]


def _entries(c: layers.ConstantCache):
    return {k: v.clone() for k, v in c._entries.items()}


def _unchanged(c: layers.ConstantCache, before) -> None:
    assert set(c._entries) == set(before)
    for k, v in c._entries.items():
        assert not v.requires_grad, k
        assert _equal(v, before[k]), k


def test_warm_eval_forward_builds_nothing(cache, monkeypatch):
    runner, staged = _runner()
    kw = dict(use_class_names=True, num_class_names=K)
    with torch.no_grad():
        cold = runner.model(staged, **kw)
        filled, entries = cache.info(), _entries(cache)
        calls = _count_table_calls(monkeypatch)
        warm = runner.model(staged, **kw)
    info = cache.info()
    assert filled.misses == filled.entries > 0
    assert info.misses == filled.misses and info.hits > filled.hits
    assert not calls, calls
    _unchanged(cache, entries)
    assert len(_flat(cold)) == len(_flat(warm)) > 0
    for a, b in zip(_flat(cold), _flat(warm)):
        assert _equal(a, b)


def _grads(trainer):
    return [(n, p.grad) for n, p in trainer.trainable]


def test_warm_training_step_builds_nothing(cache, monkeypatch):
    (t_cold, batch), (t_warm, _) = _trainer(), _trainer()
    assert t_cold.model.pixel_decoder.remat
    loss_cold = t_cold.step(batch)["loss"]
    filled, entries = cache.info(), _entries(cache)
    calls = _count_table_calls(monkeypatch)
    loss_warm = t_warm.step(batch)["loss"]
    info = cache.info()
    assert filled.misses > 0 and info.misses == filled.misses
    assert not calls, calls
    _unchanged(cache, entries)
    assert _equal(loss_cold, loss_warm)
    for (n, g), (_, h) in zip(_grads(t_cold), _grads(t_warm)):
        assert (g is None) == (h is None), n
        assert g is None or _equal(g, h), n
    for (n, p), (_, q) in zip(t_cold.trainable, t_warm.trainable):
        assert _equal(p, q), n


def test_entry_made_in_inference_mode_serves_a_backward(cache):
    (t_inf, batch), (t_ref, _) = _trainer(), _trainer()
    with torch.inference_mode():
        t_inf.model(t_inf.stage(batch), use_class_names=True,
                    num_class_names=K)
    filled = cache.info()
    assert filled.misses > 0
    for k, v in cache._entries.items():
        assert not v.is_inference(), k
    loss = t_inf.step(batch)["loss"]  # saves the entries for its backward
    assert cache.info().misses == filled.misses
    cache._entries.clear()
    assert _equal(loss, t_ref.step(batch)["loss"])
    for (n, g), (_, h) in zip(_grads(t_inf), _grads(t_ref)):
        assert g is None or _equal(g, h), n


def test_lru_keeps_to_its_size(cache):
    size = cache.size
    for h in range(1, size + 9):
        layers.sine_table(h, 1, 2, "cpu")
    assert cache.info() == (0, size + 8, size)
    newest = layers.sine_table(size + 8, 1, 2, "cpu")  # a hit
    assert cache.info().hits == 1
    layers.sine_table(size + 9, 1, 2, "cpu")  # evicts the oldest, h = 9
    assert cache.info().entries == size
    assert ("position_embedding_sine", 9, 1, 2, torch.device("cpu")) \
        not in cache._entries
    assert layers.sine_table(size + 8, 1, 2, "cpu") is newest


def test_port_cache_is_bounded():
    assert layers._CONSTANTS.size == 64
    assert layers.constant_cache_info().entries <= layers._CONSTANTS.size


@pytest.mark.gpu
def test_warm_forward_copies_nothing_on_the_card():
    """No host-to-device copy on the card and no stream synchronize on the
    host inside any ``psalm::model*`` span of a warm forward (uint8 images,
    so the tower normalizes them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the forward's kernels have no CPU "
                    "or interpret mode")
    cfg = tiny_test_config()
    model = init_weights_(PSALM(cfg, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(0)).eval()
    runner = EvalRunner(model, cfg, num_class_names=K,
                        window_clamp_threshold=None)
    staged = runner.stage(synthetic_panoptic_batch(cfg, 2, K, (48, 64),
                                                   (30, 40), seed=1))
    staged["images"] = torch.randint(0, 256, staged["images"].shape,
                                     dtype=torch.uint8, device="cuda")
    kw = dict(use_class_names=True, num_class_names=K)
    with torch.no_grad():
        model(staged, **kw)  # cold: builds and uploads the constants
        torch.cuda.synchronize()
        misses = layers.constant_cache_info().misses
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(staged, **kw)
            torch.cuda.synchronize()
    assert layers.constant_cache_info().misses == misses
    events = list(prof.events())
    model_spans = [e for e in events
                   if e.name.startswith(spans.PREFIX + "model")]
    assert model_spans
    syncs = [e for e in events
             if e.name in ("cudaStreamSynchronize", "cudaMemcpy")
             and any(s.thread == e.thread
                     and s.time_range.start <= e.time_range.start
                     <= s.time_range.end for s in model_spans)]
    copies = [e.name for e in events if "HtoD" in e.name]
    assert not syncs, [e.name for e in syncs]
    assert not copies, copies
