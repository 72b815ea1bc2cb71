"""psalm_tpu_torch modules against their psalm_tpu counterparts on the CPU.

One random state dict in the released checkpoint's layout feeds both sides:
``convert_psalm_checkpoint`` builds the JAX variables, and
``jax_to_torch_state_dict`` carries them back to the port. Each module runs
the same seeded numpy inputs at the tiny config, in f32.

Tolerance: 1e-4 of the output's largest magnitude. Both sides compute the
same f32 products; they differ in summation order and in how LayerNorm and
GroupNorm take the variance (E[x^2] - E[x]^2 in flax, two-pass in PyTorch),
and those differences grow through the stacked layers of each module.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_convert import synthetic_torch_sd

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import SwinConfig, tiny_test_config
from psalm_tpu.eval import geometry as jgeometry
from psalm_tpu.eval import postprocess as jpostprocess
from psalm_tpu.models.mask_decoder import MaskDecoder as JMaskDecoder
from psalm_tpu.models.phi import PhiModel as JPhiModel
from psalm_tpu.models.pixel_decoder import (
    MSDeformAttnPixelDecoder as JPixelDecoder, _offset_bias_init)
from psalm_tpu.models.projector import ResNetSwinProjector as JProjector
from psalm_tpu.models.swin import SwinTransformer as JSwin
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.eval import geometry, postprocess
from psalm_tpu_torch.models.mask_decoder import MaskDecoder
from psalm_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.models.swin import SwinTransformer

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REL = 1e-4  # of the output's max magnitude; see the module docstring


def parity_state_dict(cfg, seed=0):
    """``synthetic_torch_sd`` rescaled to working magnitudes: LeCun-scale
    linear/conv weights, norm scales near 1, N(0, 1) tables, and sampling
    offsets of up to 3x the deformable-DETR init (beyond a radius of 4)."""
    rng = np.random.default_rng(seed)
    sd = synthetic_torch_sd(cfg, rng)
    tables = ("seg_query", "level_embed", "query_embed.weight",
              "query_feat.weight", "SEG_query_embed.weight",
              "embed_tokens.weight")
    for k, v in sd.items():
        if k.endswith(tables):
            sd[k] = v * 50.0
        elif k.endswith("relative_position_bias_table"):
            sd[k] = v * 25.0
        elif k.endswith(".weight") and v.ndim == 1:  # norm scales
            sd[k] = 1.0 + v * 5.0
        elif k.endswith(("weight", "in_proj_weight")) and v.ndim >= 2:
            sd[k] = v * (1.0 / np.sqrt(np.prod(v.shape[1:])) / 0.02)
    pd = cfg.pixel_decoder
    init = _offset_bias_init(pd.transformer_nheads, pd.num_feature_levels,
                             pd.enc_points)
    for i in range(pd.transformer_enc_layers):
        k = f"pixel_decoder.transformer.encoder.layers.{i}.self_attn.sampling_offsets.bias"
        sd[k] = (3.0 * init + sd[k] * 50.0).astype(np.float32)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def load_port(model, sd):
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in sd.items()})
    return model.eval()


def assert_close_rel(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max err {err:.3e} > {rel} x {scale:.3e}"


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    variables = jax.tree.map(jnp.asarray,
                             convert_psalm_checkpoint(parity_state_dict(cfg), cfg))
    port = load_port(PSALM(cfg), jax_to_torch_state_dict(variables, cfg))
    return cfg, variables, port


def _images(seed=0, S=64):
    return np.random.default_rng(seed).standard_normal((2, S, S, 3)).astype(np.float32)


def _jax_swin_feats(cfg, variables, images):
    return JSwin(cfg.swin).apply(
        {"params": variables["params"]["vision_tower"]}, jnp.asarray(images))


# window 3 with two blocks per stage: every stage pads to a window multiple
# and has a shifted block whose roll is not its own inverse
SWIN_SHIFTED = SwinConfig(embed_dim=16, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 4, 8), window_size=3)


@pytest.mark.parametrize("variant", ["tiny", "shifted"])
def test_swin(setup, variant):
    cfg, variables, port = setup
    tower = port.model.vision_tower
    if variant == "shifted":
        cfg = cfg.replace(swin=SWIN_SHIFTED)
        variables = convert_psalm_checkpoint(parity_state_dict(cfg, seed=6), cfg)
        prefix = "model.vision_tower."
        tower = SwinTransformer(cfg.swin)
        load_port(tower, {k[len(prefix):]: v for k, v in
                          jax_to_torch_state_dict(variables, cfg).items()
                          if k.startswith(prefix)})
    images = _images()
    want = _jax_swin_feats(cfg, variables, images)
    with torch.no_grad():
        got = tower(torch.from_numpy(images))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_close_rel(g.numpy(), w)


def test_projector(setup):
    cfg, variables, port = setup
    rng = np.random.default_rng(1)
    res5 = rng.standard_normal((2, 4, 6, cfg.projector.input_dim)).astype(np.float32)
    want = JProjector(cfg.projector).apply(
        {"params": variables["params"]["mm_projector"],
         "batch_stats": variables["batch_stats"]["mm_projector"]},
        jnp.asarray(res5))
    with torch.no_grad():
        got = port.model.mm_projector(torch.from_numpy(res5))
    assert_close_rel(got.numpy(), want)


def test_phi(setup):
    cfg, variables, port = setup
    rng = np.random.default_rng(2)
    B, L = 2, 24
    embeds = rng.standard_normal((B, L, cfg.phi.hidden_size)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, 17:] = False  # right padding
    want, _ = JPhiModel(cfg.phi).apply(
        {"params": variables["params"]["phi"]["model"]}, jnp.asarray(embeds),
        jnp.asarray(mask))
    with torch.no_grad():
        got = port.model(torch.from_numpy(embeds), torch.from_numpy(mask))
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("mode", ["deformable", "window"])
def test_pixel_decoder(setup, mode):
    cfg, variables, port = setup
    pd_cfg = dataclasses.replace(cfg.pixel_decoder, attention_mode=mode,
                                 window_radius=4.0)
    feats = [np.array(f) for f in
             _jax_swin_feats(cfg, variables, _images(seed=3))]
    want = JPixelDecoder(pd_cfg).apply(
        {"params": variables["params"]["pixel_decoder"]},
        [jnp.asarray(f) for f in feats])
    pix = MSDeformAttnPixelDecoder(pd_cfg)
    pix.load_state_dict(port.pixel_decoder.state_dict())
    with torch.no_grad():
        got = pix([torch.from_numpy(f) for f in feats])
    assert_close_rel(got[0].numpy(), want[0])  # mask features
    assert_close_rel(got[1].numpy(), want[1])  # encoder output, coarsest level
    for g, w in zip(got[2], want[2]):
        assert_close_rel(g.numpy(), w)


@pytest.mark.parametrize("seg_concat", [False, True])
def test_mask_decoder(setup, seg_concat):
    cfg, variables, port = setup
    md_cfg = dataclasses.replace(cfg.mask_decoder, seg_concat=seg_concat)
    rng = np.random.default_rng(4)
    B, hd, Q, K = 2, md_cfg.hidden_dim, md_cfg.num_queries, 3
    x = [rng.standard_normal((B, s, s, hd)).astype(np.float32) for s in (2, 4, 8)]
    mf = rng.standard_normal((B, 16, 16, md_cfg.mask_dim)).astype(np.float32)
    seg_query = rng.standard_normal((B, Q, hd)).astype(np.float32)
    cls = rng.standard_normal((B, K, hd)).astype(np.float32)
    valid = np.array([[True, True, True], [True, False, True]])
    seg_emb = rng.standard_normal((B, 1, hd)).astype(np.float32)
    want = JMaskDecoder(md_cfg).apply(
        {"params": variables["params"]["predictor"]}, [jnp.asarray(a) for a in x],
        jnp.asarray(mf), jnp.asarray(seg_query),
        SEG_embedding=jnp.asarray(seg_emb) if seg_concat else None,
        class_name_embedding=jnp.asarray(cls), class_name_valid=jnp.asarray(valid))
    dec = MaskDecoder(md_cfg)
    dec.load_state_dict(port.predictor.state_dict())
    with torch.no_grad():
        got = dec([torch.from_numpy(a) for a in x], torch.from_numpy(mf),
                  torch.from_numpy(seg_query),
                  SEG_embedding=torch.from_numpy(seg_emb) if seg_concat else None,
                  class_name_embedding=torch.from_numpy(cls),
                  class_name_valid=torch.from_numpy(valid))
    assert_close_rel(got["pred_masks"].numpy(), want["pred_masks"])
    g, w = got["pred_class_name_logits"].numpy(), np.asarray(
        want["pred_class_name_logits"])
    np.testing.assert_array_equal(g[~valid[:, None, :].repeat(Q, 1)], -1e9)
    assert_close_rel(np.where(g == -1e9, 0, g), np.where(w == -1e9, 0, w))
    if seg_concat:
        assert_close_rel(got["pred_SEG_logits"].numpy(), want["pred_SEG_logits"])
    for ga, wa in zip(got["aux_outputs"], want["aux_outputs"]):
        assert_close_rel(ga["pred_masks"].numpy(), wa["pred_masks"])


# the non-square cases of tests/test_golden_reference.py::_GEOM_CASES
GEOM_CASES = [((48, 64), (97, 131)), ((64, 40), (120, 75)), ((48, 56), (30, 45))]


@pytest.mark.parametrize("content,orig", GEOM_CASES)
def test_geometry(content, orig):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 16, 16)) * 4).astype(np.float32)
    bucket = (-(-orig[0] // 32) * 32, -(-orig[1] // 32) * 32)
    want = jgeometry.crop_resize_to_original(
        jnp.asarray(x), jnp.asarray(content), jnp.asarray(orig), 64, bucket)
    got = geometry.crop_resize_to_original(torch.from_numpy(x), content, orig,
                                           64, bucket)
    assert_close_rel(got.numpy(), want)
    np.testing.assert_array_equal(
        geometry.valid_mask(orig, bucket).numpy(),
        np.asarray(jgeometry.valid_mask(jnp.asarray(orig), bucket)))


def _head_inputs(seed, Q=10, K=6, H=24, W=32):
    """Several queries over the 0.8 score threshold, thing and stuff, two of
    one stuff class, overlapping column-band masks (the layout of
    tests/test_golden_reference.py::_head_inputs)."""
    rng = np.random.default_rng(seed)
    class_logits = rng.standard_normal((Q, K)).astype(np.float32)
    boost = rng.integers(0, K - 1, Q)
    for q in range(7):
        class_logits[q, boost[q]] += 8.0
    class_logits[5, :] = class_logits[4, :]
    mask_logits = np.full((Q, H, W), -6.0, np.float32)
    for q in range(Q):
        x0 = (q * W) // Q
        mask_logits[q, :, x0:min(W, x0 + W // Q + 3)] = 6.0
    mask_logits += rng.standard_normal((Q, H, W)).astype(np.float32)
    is_thing = np.array([i % 2 == 0 for i in range(K - 1)])
    valid = np.zeros((H, W), bool)
    valid[:20, :27] = True
    return class_logits, mask_logits, is_thing, valid


@pytest.mark.parametrize("seed", [9, 21, 22, 23])
def test_panoptic_and_semantic_inference(seed):
    cl, ml, is_thing, valid = _head_inputs(seed)
    j_pan, j_info = jpostprocess.panoptic_inference(
        jnp.asarray(cl), jnp.asarray(ml), jnp.asarray(is_thing), jnp.asarray(valid))
    t_pan, t_info = postprocess.panoptic_inference(
        torch.from_numpy(cl), torch.from_numpy(ml), torch.from_numpy(is_thing),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(t_pan.numpy(), np.asarray(j_pan))
    for k in ("id", "category", "isthing", "valid"):
        np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]))
    assert t_info["valid"].sum() >= 1  # the merge accepted something
    j_sem = jpostprocess.semantic_inference(jnp.asarray(cl), jnp.asarray(ml))
    t_sem = postprocess.semantic_inference(torch.from_numpy(cl),
                                           torch.from_numpy(ml))
    assert_close_rel(t_sem.numpy(), j_sem)
