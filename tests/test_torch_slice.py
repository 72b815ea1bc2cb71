"""The whole COCO-panoptic eval slice: psalm_tpu's EvalRunner and the port's
on the same spliced batch, tiny config, f32, on the non-square geometry cases
of tests/test_golden_reference.py::_GEOM_CASES.

Tolerances:
  * pred_masks and class logits: 1e-3 of the largest magnitude. The port
    holds each module to 1e-4 (tests/test_torch_modules.py); the slice
    stacks Swin, Phi, the pixel decoder and nine decoder layers, whose
    thresholded attention masks pass on the small differences.
  * panoptic_seg, segments and sem_seg: equal wherever the decision has a
    margin above 1e-3. An argmax between two near-equal scores, or a mask
    probability within 1e-3 of the 0.5 threshold, is a tie that summation
    order may break either way; it is not a port fault.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_modules import assert_close_rel, load_port, parity_state_dict

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu.data.constants import (CLS_TOKEN_INDEX, IMAGE_TOKEN_INDEX,
                                      SEG_TOKEN_INDEX)
from psalm_tpu.data.splicer import splice
from psalm_tpu.eval.runner import EvalRunner as JEvalRunner
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.eval import geometry
from psalm_tpu_torch.eval.runner import EvalRunner
from psalm_tpu_torch.models.psalm import PSALM

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

GEOM_CASES = [((48, 64), (97, 131)), ((64, 40), (120, 75)), ((48, 56), (30, 45))]
BUCKET = (128, 160)  # covers every case: one compiled JAX program
K, Q, S = 3, 10, 64
IS_THING = [True, False]
MARGIN = 1e-3


def _batch(content, orig, seed):
    (nh, nw), (H, W) = content, orig
    rng = np.random.default_rng(seed)
    ids = [11, 12, IMAGE_TOKEN_INDEX, 13, CLS_TOKEN_INDEX, CLS_TOKEN_INDEX,
           CLS_TOKEN_INDEX, 14, SEG_TOKEN_INDEX, 15, 16]
    s = splice(ids, [-100] * len(ids), num_image_tokens=1, num_seg_queries=Q,
               pad_len=S, class_name_ids=np.array([21, 22, 23, 24, 25, 26]),
               cls_indices=np.array([0, 0, 1, 2, 2, 2]))
    batch = {k: np.asarray(v)[None] for k, v in s.as_dict().items()}
    batch["images"] = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    pad = np.ones((S, S), bool)
    pad[:nh, :nw] = False
    batch["padding_mask"] = pad[None]
    batch["resized_hw"] = np.asarray([[nh, nw]])
    batch["original_hw"] = np.asarray([[H, W]])
    return batch


@pytest.fixture(scope="module")
def runners():
    cfg = tiny_test_config()
    # weight seed 3: each case's panoptic map then holds an accepted segment
    variables = jax.tree.map(jnp.asarray, convert_psalm_checkpoint(
        parity_state_dict(cfg, seed=3), cfg))
    port = load_port(PSALM(cfg, device="cpu"),
                     jax_to_torch_state_dict(variables, cfg))
    jrun = JEvalRunner(JPSALM(cfg), variables, cfg, num_class_names=K,
                       is_thing=IS_THING, bucket_hw=BUCKET)
    trun = EvalRunner(port, cfg, num_class_names=K, is_thing=IS_THING,
                      bucket_hw=BUCKET)
    return cfg, variables, jrun, trun


def _top2_margin(x, axis):
    s = np.sort(x, axis=axis)
    return np.take(s, -1, axis=axis) - np.take(s, -2, axis=axis)


def _decided(cl, mo):
    """Where the JAX side's panoptic and semantic decisions have a margin:
    (query_ok [Q], pixel_ok [H, W]) from class logits [Q, K] and restored
    mask logits [Q, H, W] (float64 numpy)."""
    probs = np.exp(cl - cl.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    scores = probs.max(-1)
    query_ok = (_top2_margin(probs, -1) > MARGIN) & \
        (np.abs(scores - 0.8) > MARGIN)
    sig = 1.0 / (1.0 + np.exp(-mo))
    keep = (probs.argmax(-1) != K - 1) & (scores > 0.8)
    pm = np.where(keep[:, None, None], scores[:, None, None] * sig, -1.0)
    pixel_ok = _top2_margin(pm, 0) > MARGIN
    pixel_ok &= (np.abs(sig - 0.5) > MARGIN).all(0)
    sem = np.einsum("qc,qhw->chw", probs[:, :-1], sig)
    pixel_ok &= _top2_margin(sem, 0) > MARGIN
    return query_ok, pixel_ok


@pytest.mark.parametrize("case", range(len(GEOM_CASES)))
def test_slice_matches_jax(runners, case):
    cfg, variables, jrun, trun = runners
    content, orig = GEOM_CASES[case]
    batch = _batch(content, orig, seed=100 + case)
    H, W = orig

    # the model's outputs
    jout = JPSALM(cfg).apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                             use_class_names=True, num_class_names=K,
                             compute_logits=False)
    with torch.no_grad():
        tout = trun.model(trun.stage(batch), num_class_names=K)
    assert_close_rel(tout["pred_masks"].numpy(), jout["pred_masks"], rel=1e-3)
    assert_close_rel(tout["pred_class_name_logits"].numpy(),
                     jout["pred_class_name_logits"], rel=1e-3)

    # the runners' results
    want = jrun.infer(batch)
    got = trun.infer(batch)
    assert got["panoptic_seg"][0].shape == want["panoptic_seg"][0].shape == (H, W)
    assert got["sem_seg"][0].shape == (H, W)

    cl = np.asarray(jout["pred_class_name_logits"][0], np.float64)
    mo = geometry.crop_resize_to_original(
        torch.from_numpy(np.array(jout["pred_masks"][0])), content, orig, S,
        BUCKET)[:, :H, :W].numpy().astype(np.float64)
    query_ok, pixel_ok = _decided(cl, mo)
    assert pixel_ok.mean() > 0.9, "too few decided pixels to compare"
    np.testing.assert_array_equal(got["sem_seg"][0][pixel_ok],
                                  want["sem_seg"][0][pixel_ok])
    assert want["segments"]["valid"].sum() >= 1
    # no query sits on the class or score threshold, so segments compare exactly
    assert query_ok.all(), "a query-level tie: the case needs another seed"
    np.testing.assert_array_equal(got["panoptic_seg"][0][pixel_ok],
                                  want["panoptic_seg"][0][pixel_ok])
    for k in ("id", "category", "isthing", "valid"):
        np.testing.assert_array_equal(got["segments"][k],
                                      want["segments"][k], err_msg=k)
