"""One clamp radius per sampling point: the port's plain K1 and K2 twins, the
pixel decoder's window modes and a tiny PSALM against psalm_tpu on the CPU.

``psalm_tpu/ops/msdeform_window.py::ms_deform_attn_window`` takes ``radius``
as a length-P sequence: point p's offset from its query's reference pixel
is clamped to +-radii[p] on each axis, and its gradient to loc is zero on
an axis where the clamp bit. The port's sampler takes the same sequence
(``msdeform.point_radii``).

Tolerances:
  * the plain forward against ``ms_deform_attn_window``: 1e-5 absolute in
    f32 (the same products, sums in another order; tests/test_torch_ops.py);
  * the plain backward against ``jax.vjp`` of it with ``custom_vjp=True``,
    as training runs it: each gradient within 1e-5 of its largest
    magnitude, offsets kept 0.05 px off whole pixels and off each point's
    clip (tests/test_torch_train_ops.py);
  * a flat radius given as a P-vector: the same bits as the float;
  * the tiny PSALM forward: 1e-3 of the largest magnitude, the slice's
    tolerance (tests/test_torch_slice.py).

The JAX functions run under ``jax.jit``: compiled once, they take a
fraction of the time eager dispatch takes here.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_modules import (assert_close_rel, load_port,
                                parity_state_dict)
from test_torch_train import _args, _batch, point_draws

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu.data.constants import (CLS_TOKEN_INDEX, IMAGE_TOKEN_INDEX,
                                      SEG_TOKEN_INDEX)
from psalm_tpu.data.splicer import splice
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu.ops.msdeform_window import ms_deform_attn_window
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.ops import msdeform
from psalm_tpu_torch.train import train as ttrain

torch.backends.cuda.matmul.allow_tf32 = False

SHAPES = ((8, 8), (4, 4), (2, 2))
RADII = (2.0, 4.0, 6.0, 8.0)
MAX_OFF = 6.0  # crosses radii 2 and 4, never 6 or 8


def point_case(seed, radii=RADII, B=1, M=2, D=8, max_off=MAX_OFF):
    """Encoder inputs (Q == S) at SHAPES with P = len(radii): pixel-centre
    reference points plus offsets of up to ``max_off`` target-level pixels,
    0.05 px off whole pixels and off each point's clip; an output
    gradient. Returns (value, loc, attn, g, off) in numpy f32."""
    rng = np.random.default_rng(seed)
    L, P = len(SHAPES), len(radii)
    ref = np.concatenate([np.stack(np.meshgrid(
        (np.arange(W) + 0.5) / W, (np.arange(H) + 0.5) / H,
        indexing="xy"), -1).reshape(-1, 2) for H, W in SHAPES], 0)
    S = ref.shape[0]
    off = rng.uniform(-max_off, max_off, size=(B, S, M, L, P, 2))
    frac = np.mod(off, 1.0)
    off = np.where(frac < 0.05, off + 0.05,
                   np.where(frac > 0.95, off - 0.05, off))
    r = np.asarray(radii)[:, None]
    off = np.where(np.abs(np.abs(off) - r) < 0.05, off * (1 - 0.1 / r), off)
    norm = np.array([[w, h] for (h, w) in SHAPES], np.float64)
    loc = (ref[None, :, None, None, None, :]
           + off / norm[None, None, None, :, None, :]).astype(np.float32)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    attn = rng.uniform(0, 1, size=(B, S, M, L, P)).astype(np.float32)
    attn /= attn.reshape(B, S, M, -1).sum(-1).reshape(B, S, M, 1, 1)
    g = rng.standard_normal((B, S, M * D)).astype(np.float32)
    return value, loc, attn, g, off


def _torch_args(value, loc, attn):
    return (torch.from_numpy(value), SHAPES, msdeform.level_starts(SHAPES),
            torch.from_numpy(loc), torch.from_numpy(attn))


def test_point_radii_normalises_a_float_and_a_sequence():
    assert msdeform.point_radii(None, 4) is None
    assert msdeform.point_radii(3, 4) == (3.0,) * 4
    assert msdeform.point_radii(np.float32(2.5), 2) == (2.5, 2.5)
    assert msdeform.point_radii([2, 4, 6, 8], 4) == RADII
    with pytest.raises(ValueError, match="per-point radii: got 3, P=4"):
        msdeform.point_radii((1, 2, 3), 4)


def test_case_crosses_some_radii_and_not_others():
    *_, off = point_case(0)
    crossed = (np.abs(off) > np.asarray(RADII)[:, None]).any(-1)  # per sample
    per_point = crossed.reshape(-1, len(RADII)).mean(0)
    assert per_point[0] > 0.3 and per_point[1] > 0.05
    assert per_point[2] == per_point[3] == 0.0


def test_plain_forward_matches_window_sampler():
    value, loc, attn, _, _ = point_case(0)
    want = jax.jit(lambda v, l, a: ms_deform_attn_window(
        v, SHAPES, l, a, tile=4, radius=RADII))(
            *map(jnp.asarray, (value, loc, attn)))
    got = msdeform.ms_deform_attn_ref(*_torch_args(value, loc, attn),
                                      radius=RADII)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # each point's own radius acts: neither the flat min nor max radius
    # gives the same result
    for flat in (min(RADII), max(RADII)):
        other = msdeform.ms_deform_attn_ref(*_torch_args(value, loc, attn),
                                            radius=flat)
        assert (other - got).abs().max() > 1e-3, flat


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max err {err:.3e} > {rel} x {scale:.3e}"


def test_plain_backward_matches_window_vjp():
    value, loc, attn, g, off = point_case(1)
    _, vjp = jax.vjp(jax.jit(lambda v, l, a: ms_deform_attn_window(
        v, SHAPES, l, a, tile=8, radius=RADII, custom_vjp=True)),
        *map(jnp.asarray, (value, loc, attn)))
    want = vjp(jnp.asarray(g))
    got = msdeform.ms_deform_attn_bwd(*_torch_args(value, loc, attn),
                                      torch.from_numpy(g), radius=RADII)
    for gt, w in zip(got, want):
        _rel_close(gt.numpy(), w, 1e-5)
    # d loc is zero exactly on the axes whose offset passed its own radius
    clipped = np.abs(off) > np.asarray(RADII)[:, None]
    d_loc = got[1].numpy()
    np.testing.assert_array_equal(d_loc == 0, np.asarray(want[1]) == 0)
    assert (d_loc[clipped] == 0).all() and clipped.any()
    assert (d_loc[~clipped] != 0).any()


def test_flat_radius_as_a_vector_gives_the_same_bits():
    value, loc, attn, g, _ = point_case(2)
    args = _torch_args(value, loc, attn)
    for r in (2.0, 2.5, 0.3):
        vec = (r,) * len(RADII)
        assert torch.equal(msdeform.ms_deform_attn_ref(*args, radius=r),
                           msdeform.ms_deform_attn_ref(*args, radius=vec))
        assert torch.equal(msdeform.ms_deform_attn(*args, radius=r),
                           msdeform.ms_deform_attn_ref(*args, radius=vec))
        for a, b in zip(msdeform.ms_deform_attn_bwd(*args, torch.from_numpy(g),
                                                    radius=r),
                        msdeform.ms_deform_attn_bwd_ref(
                            *args, torch.from_numpy(g), radius=vec)):
            assert torch.equal(a, b)
        (m_flat, n_flat) = msdeform.ms_deform_attn_bwd_magnitude(
            *args, torch.from_numpy(g), radius=r)
        (m_vec, n_vec) = msdeform.ms_deform_attn_bwd_magnitude(
            *args, torch.from_numpy(g), radius=vec)
        assert n_flat == n_vec
        assert all(torch.equal(a, b) for a, b in zip(m_flat, m_vec))


def test_flat_radius_keeps_the_bits_of_the_scalar_clamp(monkeypatch):
    """The plain twins with one float radius clamped by that float, as they
    did before the radius became a P-vector, give the bits the vector
    gives now."""
    value, loc, attn, g, _ = point_case(4)
    args = (*_torch_args(value, loc, attn), torch.from_numpy(g))
    now = [msdeform.ms_deform_attn_ref(*args[:5], radius=2.5),
           *msdeform.ms_deform_attn_bwd_ref(*args, radius=2.5)]

    def scalar_coords(loc_bm, lid, H, W, radius, ref):
        x = loc_bm[:, :, lid, :, 0] * W - 0.5
        y = loc_bm[:, :, lid, :, 1] * H - 0.5
        if radius is None:
            return x, y, None, None
        rx = ref[:, lid, 0][None, :, None]
        ry = ref[:, lid, 1][None, :, None]
        dx, dy = x - rx, y - ry
        return (rx + torch.clamp(dx, -radius, radius),
                ry + torch.clamp(dy, -radius, radius),
                dx.abs() <= radius, dy.abs() <= radius)

    monkeypatch.setattr(msdeform, "_level_coords", scalar_coords)
    monkeypatch.setattr(msdeform, "_radius_tensor",
                        lambda radius, P, device: radius)
    before = [msdeform.ms_deform_attn_ref(*args[:5], radius=2.5),
              *msdeform.ms_deform_attn_bwd_ref(*args, radius=2.5)]
    for a, b in zip(now, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mutant", [0, -1], ids=["radius0", "max_radius"])
def test_one_radius_for_every_point_fails_the_limit(mutant):
    """The mutant of tools/kernel_mutants.py (``k1_k2_one_radius``: every
    point clamped at radius[0]), and one clamping at max(radii), emulated
    by the plain sampler: both fail K1's limit by more than 10x."""
    value, loc, attn, _, _ = point_case(3)
    args = _torch_args(value, loc, attn)
    want = msdeform.ms_deform_attn_ref(*args, radius=RADII)
    mag = msdeform.ms_deform_attn_magnitude(*args, radius=RADII)
    limit = msdeform.ms_deform_attn_limit(want, mag, torch.float32)
    got = msdeform.ms_deform_attn_ref(*args, radius=RADII[mutant])
    diff = (got - want).abs()
    assert (diff / limit).masked_fill(diff == 0, 0.0).max() > 10


def _pixel_decoder_cfg(mode, **kw):
    cfg = tiny_test_config()
    return dataclasses.replace(cfg.pixel_decoder, attention_mode=mode, **kw)


@pytest.fixture(scope="module")
def setup():
    """The tiny config, its JAX variables and the port's state dict from
    them, and random res2..res5 features."""
    cfg = tiny_test_config()
    variables = jax.tree.map(jnp.asarray, convert_psalm_checkpoint(
        parity_state_dict(cfg), cfg))
    sd = jax_to_torch_state_dict(variables, cfg)
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((2, cfg.image_size // s, cfg.image_size // s,
                                  c)).astype(np.float32)
             for s, c in zip((4, 8, 16, 32), cfg.pixel_decoder.in_channels)]
    return cfg, variables, sd, feats


def _port_pixel_decoder(sd, pd_cfg, feats):
    pix = MSDeformAttnPixelDecoder(pd_cfg)
    pre = "pixel_decoder."
    load_port(pix, {k[len(pre):]: v for k, v in sd.items()
                    if k.startswith(pre)})
    with torch.no_grad():
        return pix, pix([torch.from_numpy(f) for f in feats])


def test_pixel_decoder_takes_window_point_radii(setup):
    """The window mode clamps each point at its own radius (the forward
    against JAX's is ``test_psalm_forward_with_point_radii_matches_jax``);
    the clamp is live at these weights (offsets up to 3x the init), and the
    deformable mode ignores the radii, as JAX's does."""
    cfg, _, sd, feats = setup
    pix, got = _port_pixel_decoder(
        sd, _pixel_decoder_cfg("window", window_point_radii=RADII), feats)
    assert pix.radius == RADII
    assert all(layer.self_attn.radius == RADII
               for layer in pix.transformer.encoder.layers)
    exact_pix, exact = _port_pixel_decoder(
        sd, _pixel_decoder_cfg("deformable", window_point_radii=RADII), feats)
    assert exact_pix.radius is None
    assert (exact[0] - got[0]).abs().max() > 1e-3


def test_pallas3_mode_clamps_at_the_largest_radius(setup):
    """JAX's "window_pallas3" flattens per-point radii to max(radii)
    (psalm_tpu/models/pixel_decoder.py:114-116, 136-141): the port's mode
    runs K1 at max(radii), the same bits as the flat radius."""
    cfg, _, sd, feats = setup
    pix, got = _port_pixel_decoder(
        sd, _pixel_decoder_cfg("window_pallas3", window_point_radii=RADII),
        feats)
    assert pix.radius == max(RADII)
    _, flat = _port_pixel_decoder(
        sd, _pixel_decoder_cfg("window", window_radius=max(RADII)), feats)
    for g, f in zip(got[2], flat[2]):
        assert torch.equal(g, f)
    _, window = _port_pixel_decoder(
        sd, _pixel_decoder_cfg("window", window_point_radii=RADII), feats)
    assert (window[0] - got[0]).abs().max() > 1e-3


def _psalm_batch(cfg, K=3, seed=7):
    ids = [11, 12, IMAGE_TOKEN_INDEX, 13] + [CLS_TOKEN_INDEX] * K + [
        14, SEG_TOKEN_INDEX, 15]
    Q, S = cfg.mask_decoder.num_queries, cfg.image_size
    s = splice(ids, [-100] * len(ids), num_image_tokens=(S // 64) ** 2,
               num_seg_queries=Q, pad_len=64,
               class_name_ids=np.arange(21, 21 + 2 * K),
               cls_indices=np.repeat(np.arange(K), 2))
    batch = {k: np.asarray(v)[None] for k, v in s.as_dict().items()}
    batch["images"] = np.random.default_rng(seed).standard_normal(
        (1, S, S, 3)).astype(np.float32)
    return batch


def test_psalm_forward_with_point_radii_matches_jax(setup):
    cfg, variables, sd, _ = setup
    cfg = cfg.replace(pixel_decoder=_pixel_decoder_cfg(
        "window", window_point_radii=RADII))
    batch = _psalm_batch(cfg)
    want = jax.jit(functools.partial(
        JPSALM(cfg).apply, use_class_names=True, num_class_names=3,
        compute_logits=False))(variables,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    port = load_port(PSALM(cfg, device="cpu"), sd)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()},
                   num_class_names=3)
    for key in ("pred_masks", "pred_class_name_logits"):
        assert_close_rel(got[key].numpy(), want[key], rel=1e-3)


def test_window_training_step_with_point_radii():
    """Port only: a tiny Trainer.step in window mode with per-point radii
    (the config ``--window_point_radii 2,4,6,8`` builds) gives a finite
    loss and finite, nonzero gradients to the offset head."""
    args = _args(pixel_decoder_mode="window", window_radius=8.0,
                 window_point_radii="2,4,6,8", window_custom_vjp=-1)
    cfg = ttrain.build_train_config(args, base=tiny_test_config())
    assert cfg.pixel_decoder.window_point_radii == RADII
    model = load_port(PSALM(cfg, device="cpu", remat=True),
                      parity_state_dict(cfg, seed=5))
    assert model.pixel_decoder.radius == RADII
    draws = point_draws(cfg, 2)
    trainer = ttrain.Trainer(
        args, cfg=cfg, model=model, device="cpu",
        uniform_fn=lambda gen, shape: torch.from_numpy(draws[tuple(shape)]))
    metrics = trainer.step(_batch(cfg))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    grads = dict(trainer.trainable)
    for i in range(cfg.pixel_decoder.transformer_enc_layers):
        w = grads["pixel_decoder.transformer.encoder.layers."
                  f"{i}.self_attn.sampling_offsets.weight"].grad
        assert w is not None and torch.isfinite(w).all()
        assert w.abs().max() > 0
