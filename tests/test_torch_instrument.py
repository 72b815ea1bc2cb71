"""The window mode's guard against psalm_tpu's on the CPU, tiny config, f32:
``eval/instrument.py::offset_clamp_report`` per encoder layer, and
``EvalRunner``'s check, radius raise and fallback in the cases of
tests/test_instrument.py (a radius of 0.5 that the offsets pass, extreme
offsets through a patched ``summarize``, a radius that covers them), with
per-point radii, and with ``window_check_every=2`` over three batches.

The weights are ``parity_state_dict``'s with the offset head scaled by 1/4:
its offsets then reach 4.55 px and vary with the image (the init's zero
weight would make them the bias alone), so a radius of 0.5 clamps most
samples and the raise (to 6) covers them all.

Tolerances: the report's statistics within 1e-5 (the clamp share is a mean
of 0/1 values, summed in another order); ``window_stats`` the same; the new
radius and mode equal; panoptic_seg and sem_seg equal wherever the
decision has a margin above 1e-3 (tests/test_torch_slice.py's rule, on the
port's own outputs at the runner's final config).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_modules import load_port, parity_state_dict
from test_torch_slice import BUCKET, IS_THING, K, _batch, _decided

import psalm_tpu.eval.instrument as jinstrument
from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu.eval.runner import EvalRunner as JEvalRunner
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.eval import geometry
import psalm_tpu_torch.eval.instrument as tinstrument
from psalm_tpu_torch.eval.runner import EvalRunner
from psalm_tpu_torch.models.psalm import PSALM

CONTENT, ORIG = (48, 64), (97, 131)
S = 64
PP_RADII = (0.5, 1.0, 1.5, 2.0)


@pytest.fixture(scope="module")
def weights():
    base = tiny_test_config()
    sd = parity_state_dict(base, seed=3)
    for k in sd:
        if "sampling_offsets" in k:
            sd[k] = sd[k] * 0.25
    variables = jax.tree.map(jnp.asarray, convert_psalm_checkpoint(sd, base))
    return variables, jax_to_torch_state_dict(variables, base)


def _cfg(mode="window", **kw):
    base = tiny_test_config()
    return base.replace(pixel_decoder=dataclasses.replace(
        base.pixel_decoder, attention_mode=mode, **kw))


def _runners(weights, cfg, **kw):
    variables, sd = weights
    jrun = JEvalRunner(JPSALM(cfg), variables, cfg, num_class_names=K,
                       is_thing=IS_THING, bucket_hw=BUCKET, **kw)
    trun = EvalRunner(load_port(PSALM(cfg, device="cpu"), sd), cfg,
                      num_class_names=K, is_thing=IS_THING, bucket_hw=BUCKET,
                      **kw)
    return jrun, trun


def _same_stats(got, want):
    assert got is not None and want is not None
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


def _same_maps(trun, got, want, batch):
    """panoptic_seg and sem_seg equal on the decided pixels, the margins
    from the port's model at the runner's final config."""
    with torch.no_grad():
        out = trun.model(trun.stage(batch), num_class_names=K)
    H, W = ORIG
    cl = out["pred_class_name_logits"][0].double().numpy()
    mo = geometry.crop_resize_to_original(
        out["pred_masks"][0], CONTENT, ORIG, S, BUCKET)[:, :H, :W]
    _, pixel_ok = _decided(cl, mo.double().numpy())
    assert pixel_ok.mean() > 0.9, "too few decided pixels to compare"
    for key in ("panoptic_seg", "sem_seg"):
        np.testing.assert_array_equal(got[key][0][pixel_ok],
                                      want[key][0][pixel_ok])


@pytest.fixture(scope="module")
def point_radii_case(weights):
    """Per-point radii that the offsets pass, both runners on one batch,
    and both packages' reports of it: JAX's through the instrumented
    forward its runner compiled for its check (the same model, variables,
    staged batch and arguments)."""
    variables, sd = weights
    cfg = _cfg(window_point_radii=PP_RADII)
    jrun, trun = _runners(weights, cfg)
    batch = _batch(CONTENT, ORIG, seed=201)
    jmodel, jstaged = jrun.model, jrun.stage(batch)
    want, got = jrun.infer(batch), trun.infer(batch)
    jreport = jinstrument.offset_clamp_report(
        jmodel, variables, jstaged, use_class_names=True,
        use_seg_embedding=False, use_regions=False, max_regions=0,
        num_class_names=K, compute_logits=False)
    port = load_port(PSALM(cfg, device="cpu"), sd)
    treport = tinstrument.offset_clamp_report(
        port, {"images": torch.from_numpy(batch["images"])})
    return dict(cfg=cfg, jrun=jrun, trun=trun, batch=batch, want=want,
                got=got, jreport=jreport, treport=treport, port=port)


def test_offset_clamp_report_matches_jax_per_layer(point_radii_case):
    case = point_radii_case
    cfg, want, got, port = (case["cfg"], case["jreport"], case["treport"],
                            case["port"])
    assert list(got) == [f"encoder_layer_{i}" for i in
                         range(cfg.pixel_decoder.transformer_enc_layers)]
    assert set(got) == set(want)
    for layer, stats in want.items():
        assert set(got[layer]) == set(stats) == {"offset_max", "clamp_frac"}
        for k in stats:
            assert abs(got[layer][k] - stats[k]) <= 1e-5, (layer, k)
        assert 0.0 < stats["clamp_frac"] < 1.0  # the radii bite, not all
    assert tinstrument.summarize(got) == jinstrument.summarize(got)
    # the recording is off again, and "window_pallas3" reports at the
    # radius it applies, max(radii), as JAX's layer does
    assert all(layer.self_attn.offset_stats is None and
               not layer.self_attn.record_offsets
               for layer in port.pixel_decoder.transformer.encoder.layers)
    images = {"images": torch.from_numpy(case["batch"]["images"])}
    port.pixel_decoder.configure_sampler(_cfg(
        "window_pallas3", window_point_radii=PP_RADII).pixel_decoder)
    flat = tinstrument.offset_clamp_report(port, images)
    port.pixel_decoder.configure_sampler(_cfg(
        window_radius=max(PP_RADII)).pixel_decoder)
    assert flat == tinstrument.offset_clamp_report(port, images)


def _count_checks(monkeypatch, module):
    calls = []
    real = module.offset_clamp_report

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(module, "offset_clamp_report", counted)
    return calls


def test_runner_raises_the_radius_as_jax_does(weights, monkeypatch):
    """JAX's first case (radius 0.5), over three batches with a check every
    two: both runners check batches 0 and 2, raise the radius to
    ceil(max |offset|) + 1 = 6 at the first and keep it at the second. The
    port as it was, without the guard (``window_clamp_threshold=None``:
    radius 0.5 kept), gives other maps than JAX's runner."""
    cfg = _cfg(window_radius=0.5)
    jrun, trun = _runners(weights, cfg, window_clamp_threshold=1e-3,
                          window_check_every=2)
    _, bare = _runners(weights, cfg, window_clamp_threshold=None)
    jcalls = _count_checks(monkeypatch, jinstrument)
    tcalls = _count_checks(monkeypatch, tinstrument)
    for i in range(3):
        batch = _batch(CONTENT, ORIG, seed=200 + i)
        want, got = jrun.infer(batch), trun.infer(batch)
        _same_maps(trun, got, want, batch)
        if i == 0:
            old = bare.infer(batch)
            assert (old["panoptic_seg"][0] != want["panoptic_seg"][0]
                    ).mean() > 0.01
    assert len(jcalls) == len(tcalls) == 2
    assert bare.window_stats is None and bare.model.pixel_decoder.radius == 0.5
    _same_stats(trun.window_stats, jrun.window_stats)
    assert trun.window_stats["max_clamp_frac"] > 1e-3
    assert trun.cfg.pixel_decoder == jrun.cfg.pixel_decoder
    assert trun.cfg.pixel_decoder.attention_mode == "window"
    assert trun.cfg.pixel_decoder.window_radius == 6.0
    pix = trun.model.pixel_decoder
    assert pix.radius == 6.0 and trun.model.cfg.pixel_decoder.window_radius == 6
    assert all(layer.self_attn.radius == 6.0
               for layer in pix.transformer.encoder.layers)


def test_runner_falls_back_to_the_exact_sampler(weights, monkeypatch):
    """JAX's second case: offsets reported at 50 px (a patched summarize in
    both packages) send both runners to the exact deformable sampler."""
    extreme = {"max_offset_px": 50.0, "max_clamp_frac": 0.5}
    monkeypatch.setattr(jinstrument, "summarize", lambda rep: dict(extreme))
    monkeypatch.setattr(tinstrument, "summarize", lambda rep: dict(extreme))
    cfg = _cfg(window_radius=0.5)
    jrun, trun = _runners(weights, cfg)
    batch = _batch(CONTENT, ORIG, seed=200)
    want, got = jrun.infer(batch), trun.infer(batch)
    assert jrun.cfg.pixel_decoder.attention_mode == "deformable"
    assert trun.cfg.pixel_decoder == jrun.cfg.pixel_decoder
    assert trun.model.pixel_decoder.radius is None
    assert not trun._window_enabled and trun.window_stats == extreme
    _same_maps(trun, got, want, batch)


def test_runner_keeps_a_covering_radius(weights):
    """JAX's third case: at a radius that covers the offsets (6, the one
    the first case raises to, whose check JAX has compiled by then)
    nothing is clamped; the window mode and radius stay."""
    cfg = _cfg(window_radius=6.0)
    jrun, trun = _runners(weights, cfg)
    batch = _batch(CONTENT, ORIG, seed=200)
    want, got = jrun.infer(batch), trun.infer(batch)
    _same_stats(trun.window_stats, jrun.window_stats)
    assert trun.window_stats["max_clamp_frac"] == 0.0
    assert trun.cfg == cfg and jrun.cfg.pixel_decoder == cfg.pixel_decoder
    assert trun.model.pixel_decoder.radius == 6.0
    _same_maps(trun, got, want, batch)


def test_runner_flattens_point_radii_as_jax_does(point_radii_case):
    """Per-point radii that the offsets pass: both runners raise to one
    flat radius and drop the radii."""
    case = point_radii_case
    jrun, trun = case["jrun"], case["trun"]
    _same_stats(trun.window_stats, jrun.window_stats)
    assert trun.cfg.pixel_decoder == jrun.cfg.pixel_decoder
    assert trun.cfg.pixel_decoder.window_point_radii == ()
    assert trun.model.pixel_decoder.radius == 6.0
    _same_maps(trun, case["got"], case["want"], case["batch"])


def test_guard_is_off_outside_the_window_mode(weights):
    """Port only: the deformable mode and a None threshold never check; the
    dense mode's report is empty, as JAX's sows nothing there."""
    _, sd = weights
    for cfg, kw in ((_cfg("deformable"), {}),
                    (_cfg(window_radius=0.5), dict(window_clamp_threshold=None))):
        trun = EvalRunner(load_port(PSALM(cfg, device="cpu"), sd), cfg,
                          num_class_names=K, bucket_hw=BUCKET, **kw)
        assert not trun._window_enabled
    dense = _cfg("dense", transformer_nheads=1)
    model = PSALM(dense, device="cpu")
    images = torch.zeros(1, S, S, 3)
    assert tinstrument.offset_clamp_report(model, {"images": images}) == {}
    with pytest.raises(ValueError, match="dense"):
        model.pixel_decoder.configure_sampler(_cfg().pixel_decoder)
