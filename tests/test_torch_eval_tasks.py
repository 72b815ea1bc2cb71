"""The semantic, instance, referring and region eval tasks, and the panoptic
task with the pixel decoder's dense mode: psalm_tpu's EvalRunner and the
port's on the same weights and batches, tiny config, f32, Phi's
``use_flash=True`` on both sides (the JAX side's stock flash kernel under
``force_tpu_interpret_mode()``, the port's K5 through its plain version on
the CPU). Then the pieces these tasks add, each against psalm_tpu:
``point_sample``, the region head, the instance, referring and region
heads, and ``resize_to_original``.

Tolerances, as ``tests/test_torch_slice.py`` states them: mask, class,
[SEG] and region logits and the heads' scores 1e-3 of the largest magnitude;
masks and label maps equal wherever the JAX side's decision has a margin
above 1e-3 (a mask probability that far from 0.5, a top-two gap that
large), and top-k orders compared where the JAX side's ranked scores are
that far apart. Heads and small ops: 1e-5 absolute on exact inputs, 1e-4 of
the magnitude for the region head (a stack of layers, as
``tests/test_torch_modules.py``).
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_flash import _dense_cfg, dense_mode_variables
from test_torch_modules import (assert_close_rel, load_port, parity_state_dict,
                                setup)  # noqa: F401 - the module fixture
from test_torch_slice import _decided

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import SegTask, tiny_test_config
from psalm_tpu.eval import geometry as jgeometry
from psalm_tpu.eval import postprocess as jpostprocess
from psalm_tpu.eval.runner import EvalRunner as JEvalRunner
from psalm_tpu.models.mask_decoder import MaskDecoder as JMaskDecoder
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu.ops.sampling import point_sample as jpoint_sample
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.eval import geometry, postprocess
from psalm_tpu_torch.eval.runner import (EvalRunner, synthetic_panoptic_batch,
                                         synthetic_referring_batch,
                                         synthetic_region_batch)
from psalm_tpu_torch.models.mask_decoder import MaskDecoder
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.ops.sampling import point_sample, resize_bilinear

torch.backends.cuda.matmul.allow_tf32 = False

CONTENT, ORIG, BUCKET = (48, 64), (97, 131), (128, 160)
K, S = 3, 64  # class names (the last one the background), image size
IS_THING = [True, False]
MARGIN = 1e-3
CASES = ["semantic", "instance", "referring", "region", "panoptic_dense"]


@pytest.fixture(scope="module")
def weights():
    cfg = tiny_test_config()
    variables = jax.tree.map(jnp.asarray, convert_psalm_checkpoint(
        parity_state_dict(cfg, seed=3), cfg))
    return cfg, variables


def _case(name, cfg, variables):
    """(cfg, variables, batch) of one case, batches from the port's
    synthetic builders at the real prompt shapes."""
    if name == "panoptic_dense":
        cfg = cfg.replace(seg_task=SegTask.PANOPTIC,
                          pixel_decoder=_dense_cfg(cfg))
        variables = dense_mode_variables(variables, cfg)
    else:
        cfg = cfg.replace(seg_task=SegTask(name))
    if name == "referring":
        batch = synthetic_referring_batch(cfg, 1, CONTENT, ORIG, refer_tokens=5,
                                          seed=11)
    elif name == "region":
        batch = synthetic_region_batch(cfg, 1, CONTENT, ORIG, regions=4,
                                       valid_regions=3, points=32, seed=12)
    else:
        batch = synthetic_panoptic_batch(cfg, 1, K, CONTENT, ORIG,
                                         tokens_per_class=2, seed=13)
    return cfg, variables, batch


def _flags(task, batch):
    return dict(use_class_names=task in (SegTask.PANOPTIC, SegTask.INSTANCE,
                                         SegTask.SEMANTIC),
                use_seg_embedding=task is SegTask.REFERRING,
                use_regions=task is SegTask.REGION,
                max_regions=(batch["region_points"].shape[1]
                             if "region_points" in batch else 0),
                num_class_names=K)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _ranks(t_scores, j_scores, k):
    """The top-k orders (port, JAX) of the raw scores [n] the heads rank.
    They hold the same items, and the same item at every rank whose JAX
    score is MARGIN away from both neighbours; near-equal scores may swap."""
    t_order = np.argsort(-t_scores, kind="stable")
    j_order = np.argsort(-j_scores, kind="stable")
    gap = -np.diff(j_scores[j_order])
    if k < len(j_order):
        assert gap[k - 1] > MARGIN, "a tie at the top-k cut: needs another seed"
    assert set(t_order[:k]) == set(j_order[:k])
    apart = np.ones(len(j_order), bool)
    apart[:-1] &= gap > MARGIN
    apart[1:] &= gap > MARGIN
    np.testing.assert_array_equal(t_order[:k][apart[:k]], j_order[:k][apart[:k]])
    return t_order[:k], j_order[:k]


def _check_masks(got, want, mo):
    """got/want [H, W] bool; mo [H, W] JAX mask logits on the original grid:
    equal where the probability is MARGIN away from 0.5."""
    sig = _sigmoid(mo)
    decided = np.abs(sig - 0.5) > MARGIN
    assert decided.mean() > 0.9, "too few decided pixels to compare"
    np.testing.assert_array_equal(got[decided], want[decided])
    np.testing.assert_array_equal(want, sig > 0.5)


def _probs(logits):
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("name", CASES)
def test_runner_matches_jax(weights, name):
    cfg, variables, batch = _case(name, *weights)
    task = cfg.seg_task
    flags = _flags(task, batch)
    with pltpu.force_tpu_interpret_mode():
        jout = jax.jit(lambda v, b: JPSALM(cfg, use_flash=True).apply(
            v, b, compute_logits=False, **flags))(
                variables, {k: jnp.asarray(v) for k, v in batch.items()})
    # JAX's runner on the model outputs above (one compiled forward per
    # case): its model stands in for PSALM(cfg, use_flash=True) and checks
    # that the runner asks for the same conditioning
    asked = []
    jmodel = types.SimpleNamespace(
        apply=lambda v, b, **kw: asked.append(kw) or jout)
    want = JEvalRunner(jmodel, variables, cfg, num_class_names=K,
                       is_thing=IS_THING, bucket_hw=BUCKET).infer(batch)
    assert asked == [dict(flags, compute_logits=False)]
    port = load_port(PSALM(cfg, device="cpu", use_flash=True),
                     jax_to_torch_state_dict(variables, cfg))
    trun = EvalRunner(port, cfg, num_class_names=K, is_thing=IS_THING,
                      bucket_hw=BUCKET)
    with torch.no_grad():
        tout = port(trun.stage(batch), **flags)
    got = trun.infer(batch)

    assert_close_rel(tout["pred_masks"].numpy(), jout["pred_masks"], rel=1e-3)
    logit_key = {SegTask.REFERRING: "pred_SEG_logits",
                 SegTask.REGION: "pred_region_logits"}.get(
                     task, "pred_class_name_logits")
    for key in ("pred_SEG_logits", "pred_class_name_logits",
                "pred_region_logits"):
        assert (tout[key] is None) == (jout[key] is None) == (key != logit_key)
    tl, jl = tout[logit_key].numpy(), np.asarray(jout[logit_key])
    np.testing.assert_array_equal(tl == -1e9, jl == -1e9)
    assert_close_rel(np.where(tl == -1e9, 0, tl), np.where(jl == -1e9, 0, jl),
                     rel=1e-3)

    H, W = ORIG
    jl = jl[0].astype(np.float64)
    mo = geometry.crop_resize_to_original(
        torch.from_numpy(np.array(jout["pred_masks"][0])), CONTENT, ORIG, S,
        BUCKET)[:, :H, :W].numpy().astype(np.float64)
    if task is SegTask.PANOPTIC:
        query_ok, pixel_ok = _decided(jl, mo)
        assert query_ok.all(), "a query-level tie: the case needs another seed"
        assert pixel_ok.mean() > 0.9 and want["segments"]["valid"].sum() >= 1
        for k in ("panoptic_seg", "sem_seg"):
            np.testing.assert_array_equal(got[k][0][pixel_ok],
                                          want[k][0][pixel_ok], err_msg=k)
        for k in ("id", "category", "isthing", "valid"):
            np.testing.assert_array_equal(got["segments"][k],
                                          want["segments"][k], err_msg=k)
    elif task is SegTask.SEMANTIC:
        up = resize_bilinear(torch.from_numpy(np.array(jout["pred_masks"][0]))
                             [..., None], (S, S))[..., 0]
        sig = geometry.resize_to_original(torch.sigmoid(up), CONTENT, ORIG,
                                          BUCKET)[:, :H, :W].numpy()
        probs = np.exp(jl - jl.max(-1, keepdims=True))
        probs = (probs / probs.sum(-1, keepdims=True))[:, :-1]
        sem = np.sort(np.einsum("qk,qhw->khw", probs, sig), axis=0)
        decided = sem[-1] - sem[-2] > MARGIN
        assert decided.mean() > 0.9
        assert got["sem_seg"][0].shape == (H, W)
        np.testing.assert_array_equal(got["sem_seg"][0][decided],
                                      want["sem_seg"][0][decided])
    else:
        key = {SegTask.INSTANCE: "instances", SegTask.REFERRING: "referring",
               SegTask.REGION: "region"}[task]
        g, w = got[key], want[key]
        assert sorted(g) == sorted(w)
        Q = mo.shape[0]
        tl = tl[0].astype(np.float64)
        if task is SegTask.INSTANCE:
            t_ord, j_ord = _ranks(_probs(tl)[:, :-1].reshape(-1),
                                  _probs(jl)[:, :-1].reshape(-1), Q)
            np.testing.assert_array_equal(g["classes"][0], t_ord % (K - 1))
            np.testing.assert_array_equal(w["classes"][0], j_ord % (K - 1))
            t_q, j_q = t_ord // (K - 1), j_ord // (K - 1)
        elif task is SegTask.REFERRING:
            t_ord, j_ord = _ranks(_sigmoid(tl[:, 0]), _sigmoid(jl[:, 0]), Q)
            np.testing.assert_array_equal(g["query"][0], t_ord)
            np.testing.assert_array_equal(w["query"][0], j_ord)
            t_q, j_q = t_ord, j_ord
        else:
            t_ord = j_ord = t_q = j_q = np.arange(Q)
            assert (w["scores"][0][:, 3] == 0).all()  # the invalid region
        assert g["masks"][0].shape == w["masks"][0].shape == (Q, H, W)
        scale = np.abs(w["scores"]).max()
        for j_rank, item in enumerate(j_ord):
            t_rank = int(np.flatnonzero(t_ord == item)[0])
            assert np.abs(g["scores"][0][t_rank]
                          - w["scores"][0][j_rank]).max() <= 1e-3 * scale
            if "keep" in w:
                assert g["keep"][0][t_rank] == w["keep"][0][j_rank]
            assert t_q[t_rank] == j_q[j_rank]
            _check_masks(g["masks"][0][t_rank], w["masks"][0][j_rank],
                         mo[j_q[j_rank]])


@pytest.mark.parametrize("align_corners", [False, True])
def test_point_sample_matches_jax(align_corners):
    rng = np.random.default_rng(8)
    feat = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    # inside, on the border and off the map
    coords = rng.uniform(-0.2, 1.2, (2, 40, 2)).astype(np.float32)
    coords[:, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    want = jpoint_sample(jnp.asarray(feat), jnp.asarray(coords),
                         align_corners=align_corners)
    got = point_sample(torch.from_numpy(feat), torch.from_numpy(coords),
                       align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_sample_regions_matches_jax(setup):  # noqa: F811
    cfg, variables, port = setup
    rng = np.random.default_rng(9)
    tokens = rng.standard_normal((2, 16, cfg.phi.hidden_size)).astype(np.float32)
    pts = rng.uniform(0, 1, (2, 3, 32, 2)).astype(np.float32)
    want = JPSALM(cfg).apply(variables, jnp.asarray(tokens), jnp.asarray(pts),
                             method=JPSALM.sample_regions)
    got = port.sample_regions(torch.from_numpy(tokens), torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seg_concat", [False, True])
def test_region_head_matches_jax(setup, seg_concat):  # noqa: F811
    cfg, variables, port = setup
    md_cfg = dataclasses.replace(cfg.mask_decoder, seg_concat=seg_concat)
    rng = np.random.default_rng(10)
    B, hd, R = 2, md_cfg.hidden_dim, 3
    x = [rng.standard_normal((B, s, s, hd)).astype(np.float32) for s in (2, 4, 8)]
    mf = rng.standard_normal((B, 16, 16, md_cfg.mask_dim)).astype(np.float32)
    seg_query = rng.standard_normal((B, md_cfg.num_queries, hd)).astype(np.float32)
    seg_emb = rng.standard_normal((B, 1, hd)).astype(np.float32)
    region = rng.standard_normal((B, R, hd)).astype(np.float32)
    valid = np.array([[True, True, False], [True, True, True]])
    args = (x, mf, seg_query)
    kw = dict(SEG_embedding=seg_emb, region_embedding=region,
              region_valid=valid)
    want = JMaskDecoder(md_cfg).apply(
        {"params": variables["params"]["predictor"]},
        [jnp.asarray(a) for a in x], *map(jnp.asarray, args[1:]),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    dec = MaskDecoder(md_cfg)
    dec.load_state_dict(port.predictor.state_dict())
    with torch.no_grad():
        got = dec([torch.from_numpy(a) for a in x], *map(torch.from_numpy, args[1:]),
                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got["pred_class_name_logits"] is None
    outs = [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"]))
    for g, w in outs:
        g, w = g["pred_region_logits"].numpy(), np.asarray(w["pred_region_logits"])
        assert g.shape == (B, R, md_cfg.num_queries)
        np.testing.assert_array_equal(g[~valid], -1e9)
        assert_close_rel(g[valid], w[valid])
    assert_close_rel(got["pred_SEG_logits"].numpy(), want["pred_SEG_logits"])


def _mask_logits(seed, Q=10, H=24, W=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Q, H, W)) * 4).astype(np.float32)


@pytest.mark.parametrize("with_thing", [False, True])
def test_instance_inference_matches_jax(with_thing):
    rng = np.random.default_rng(14)
    cl = (rng.standard_normal((10, 6)) * 3).astype(np.float32)
    ml = _mask_logits(15)
    is_thing = np.array([True, False, True, True, False])
    want = jpostprocess.instance_inference(
        jnp.asarray(cl), jnp.asarray(ml), topk=10,
        is_thing=jnp.asarray(is_thing) if with_thing else None)
    got = postprocess.instance_inference(
        torch.from_numpy(cl), torch.from_numpy(ml), topk=10,
        is_thing=torch.from_numpy(is_thing) if with_thing else None)
    for k in ("masks", "classes", "keep"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=1e-6)


def test_referring_and_region_heads_match_jax():
    rng = np.random.default_rng(16)
    seg = (rng.standard_normal((10, 1)) * 3).astype(np.float32)
    reg = (rng.standard_normal((4, 10)) * 3).astype(np.float32)
    reg[3] = -1e9  # an invalid region
    ml = _mask_logits(17)
    want = jpostprocess.seg_instance_inference(jnp.asarray(seg), jnp.asarray(ml),
                                               topk=10)
    got = postprocess.seg_instance_inference(torch.from_numpy(seg),
                                             torch.from_numpy(ml), topk=10)
    want_r = jpostprocess.region_inference(jnp.asarray(reg), jnp.asarray(ml))
    got_r = postprocess.region_inference(torch.from_numpy(reg),
                                         torch.from_numpy(ml))
    for g, w, exact in ((got, want, ("masks", "query")),
                        (got_r, want_r, ("masks",))):
        assert sorted(g) == sorted(w)
        for k in exact:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), k)
        np.testing.assert_allclose(g["scores"].numpy(), np.asarray(w["scores"]),
                                   rtol=0, atol=1e-6)
    assert got_r["scores"].shape == (10, 4) and (got_r["scores"][:, 3] == 0).all()


@pytest.mark.parametrize("content,orig", [((48, 64), (97, 131)),
                                          ((64, 40), (120, 75)),
                                          ((48, 56), (30, 45))])
def test_resize_to_original_matches_jax(content, orig):
    x = _mask_logits(18, Q=3, H=64, W=64)
    bucket = (-(-orig[0] // 32) * 32, -(-orig[1] // 32) * 32)
    want = jgeometry.resize_to_original(jnp.asarray(x), jnp.asarray(content),
                                        jnp.asarray(orig), bucket)
    got = geometry.resize_to_original(torch.from_numpy(x), content, orig, bucket)
    assert_close_rel(got.numpy(), want, rel=1e-5)
    assert not got[:, orig[0]:].any() and not got[:, :, orig[1]:].any()


def test_synthetic_batches_have_the_real_prompt_shapes():
    cfg = tiny_test_config()
    ref = synthetic_referring_batch(cfg, 2, CONTENT, ORIG, refer_tokens=5)
    assert ref["tok_ids"].shape[1] % 128 == 0
    assert (ref["refer_embedding_indices"].sum(-1) == 5).all()
    reg = synthetic_region_batch(cfg, 2, CONTENT, ORIG, regions=4,
                                 valid_regions=3, points=32)
    assert reg["region_points"].shape == (2, 4, 32, 2)
    np.testing.assert_array_equal(reg["region_valid"],
                                  [[True] * 3 + [False]] * 2)
    assert (reg["region_embedding_mask"].sum(-1) == 3).all()
    pts = reg["region_points"][:, :3]
    assert (pts >= 0).all() and (pts[..., 0] < CONTENT[1] / S).all() \
        and (pts[..., 1] < CONTENT[0] / S).all()
