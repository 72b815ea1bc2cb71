"""The port's criterion against psalm_tpu's on the CPU, in f32: the loss
components and the matching on numpy-made outputs and targets, for the
panoptic (class names), referring ([SEG]) and region flags, with the
image-shared and the per-mask uncertainty points. Both sides draw the same
points: ``uniform_fn`` returns one fixed numpy array per draw shape.

Tolerances: losses 1e-5 relative (the same f32 arithmetic in another
order). The matching (``src_idx``) is compared exactly where the JAX cost
matrix decides it: for every matched target, forbidding its pair and
solving again must cost at least 1e-3 more. Where a rival assignment is
within 1e-3, the two sides' rounding may pick either, and only the total
cost of the port's assignment is held to JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from psalm_tpu.config import LossConfig as JLossConfig
from psalm_tpu.train.criterion import PSALMCriterion as JCriterion
from psalm_tpu_torch.config import LossConfig
from psalm_tpu_torch.train.criterion import PSALMCriterion, hungarian_assign

B, Q, K, N, R, P = 2, 6, 4, 3, 3, 16
MARGIN = 1e-3


def _draws(seed=1):
    c = LossConfig(train_num_points=P)
    n_sampled, n_unc = int(P * c.oversample_ratio), int(
        c.importance_sample_ratio * P)
    rng = np.random.default_rng(seed)
    return {s: rng.uniform(size=s).astype(np.float32)
            for rows in (B, B * N)
            for s in ((rows, P, 2), (rows, n_sampled, 2), (rows, P - n_unc, 2))}


def _case(seed, valid=((True, True, True), (True, True, False)), aux=2):
    """Outputs of 1 + ``aux`` layers at mask size 16 and targets at 32."""
    rng = np.random.default_rng(seed)

    def layer():
        return {"pred_masks": (3 * rng.standard_normal((B, Q, 16, 16))
                               ).astype(np.float32),
                "pred_class_name_logits": rng.standard_normal(
                    (B, Q, K)).astype(np.float32),
                "pred_SEG_logits": rng.standard_normal((B, Q, 1)).astype(
                    np.float32),
                "pred_region_logits": rng.standard_normal((B, R, Q)).astype(
                    np.float32)}

    outputs = layer()
    outputs["aux_outputs"] = [layer() for _ in range(aux)]
    targets = {"masks": (rng.uniform(size=(B, N, 32, 32)) > 0.6).astype(
                   np.uint8),
               "labels": rng.integers(0, K - 1, size=(B, N)),
               "valid": np.asarray(valid)}
    return outputs, targets


def _to(fn, tree):
    if isinstance(tree, dict):
        return {k: _to(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(fn, v) for v in tree]
    return fn(tree)


def _both(outputs, targets, per_mask, **flags):
    draws = _draws()
    jcrit = JCriterion(JLossConfig(train_num_points=P), Q,
                       per_mask_uncertainty=per_mask,
                       uniform_fn=lambda key, shape: draws[tuple(shape)])
    tcrit = PSALMCriterion(LossConfig(train_num_points=P), Q,
                           per_mask_uncertainty=per_mask,
                           uniform_fn=lambda g, shape: torch.from_numpy(
                               draws[tuple(shape)]))
    jo, jt = _to(jnp.asarray, outputs), _to(jnp.asarray, targets)
    to, tt = _to(torch.from_numpy, outputs), _to(torch.from_numpy, targets)
    want = jcrit(jax.random.PRNGKey(0), jo, jt, **flags)
    got = tcrit(torch.Generator(), to, tt, **flags)
    return ({k: float(v) for k, v in want.items()},
            {k: float(v) for k, v in got.items()},
            (jcrit, jo, jt), (tcrit, to, tt))


def _decided(cost, src, n):
    """Per matched target: does forbidding its pair raise the optimum by
    more than MARGIN (float64 on JAX's cost matrix)?"""
    c = np.asarray(cost, np.float64)[:, :n]
    best = c[src[:n], np.arange(n)].sum()
    out = []
    for j in range(n):
        alt = c.copy()
        alt[src[j], j] = 1e9
        r, cols = linear_sum_assignment(alt)
        out.append(alt[r, cols].sum() > best + MARGIN)
    return np.asarray(out)


FLAGS = {"panoptic": dict(compute_class=True),
         "referring": dict(compute_seg=True, compute_class=False),
         "region": dict(compute_region=True, compute_class=False)}


@pytest.mark.parametrize("per_mask", [False, True])
@pytest.mark.parametrize("task", sorted(FLAGS))
def test_losses_and_matching_match_jax(task, per_mask):
    outputs, targets = _case(3)
    want, got, (jcrit, jo, jt), (tcrit, to, tt) = _both(
        outputs, targets, per_mask, **FLAGS[task])
    # the padding fault (module docstring of train/criterion.py) does not
    # arise: no valid target of a padded image is matched to query 0
    assert set(want) == set(got)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), \
            (k, got[k], want[k])
    on = [k for k, v in want.items() if v > 0]
    assert "loss_mask" in on and "loss_dice" in on and len(on) >= 4, on

    # the final layer's matching
    jcost, n_valid = jcrit.match_cost(jax.random.PRNGKey(0), jo, jt)
    tcost, t_n = tcrit.match_cost(None, to, tt)
    np.testing.assert_allclose(tcost.numpy(), np.asarray(jcost), rtol=1e-5,
                               atol=1e-5)
    jsrc, jvalid = map(np.asarray, jcrit.match(jax.random.PRNGKey(0), jo, jt))
    tsrc, tvalid = tcrit.match(None, to, tt)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    compared = 0
    for b in range(B):
        n = int(n_valid[b])
        c = np.asarray(jcost[b], np.float64)
        assert abs(c[tsrc[b, :n].numpy(), np.arange(n)].sum()
                   - c[jsrc[b, :n], np.arange(n)].sum()) <= 1e-4
        ok = _decided(jcost[b], jsrc[b], n)
        np.testing.assert_array_equal(tsrc[b, :n].numpy()[ok], jsrc[b, :n][ok])
        compared += ok.sum()
        assert (0 not in jsrc[b, :n]) or n == N, "padding fault case"
    assert compared >= B * N - 2, "too few decided pairs: take another seed"


def test_hungarian_assign_pads_and_orders_by_target():
    rng = np.random.default_rng(3)
    cost = rng.standard_normal((2, 5, 4)).astype(np.float32)
    src, valid = hungarian_assign(torch.from_numpy(cost),
                                  torch.tensor([4, 2]))
    for b, n in enumerate((4, 2)):
        rows, cols = linear_sum_assignment(cost[b, :, :n].astype(np.float64))
        np.testing.assert_array_equal(src[b, :n].numpy(), rows[np.argsort(cols)])
        assert valid[b, :n].all() and not valid[b, n:].any()
        assert (src[b, n:] == 0).all()


def test_class_labels_skip_padding_where_jax_overwrites():
    """A valid target matched to query 0 in an image with a padding slot:
    JAX's ``.at[src].set`` over every slot lets the padding slot (query 0,
    background) overwrite that target's label; the port keeps it. The port
    then equals JAX on the same image without the padding slot."""
    outputs, targets = _case(5, valid=((True, True, False),) * B, aux=0)
    # target 0 of each image is query 0's mask and class, nearly exactly
    for b in range(B):
        m = targets["masks"][b, 0, ::2, ::2]
        targets["masks"][b, 0] = np.kron(m, np.ones((2, 2), np.uint8))
        outputs["pred_masks"][b, 0] = np.where(m, 9.0, -9.0)
        outputs["pred_class_name_logits"][b, 0, targets["labels"][b, 0]] = 9.0
    want, got, (jcrit, jo, jt), _ = _both(outputs, targets, False)
    jsrc, _ = jcrit.match(jax.random.PRNGKey(0), jo, jt)
    assert (np.asarray(jsrc)[:, 0] == 0).all()
    assert got["loss_class_name_class"] < want["loss_class_name_class"]
    trimmed = {k: v[:, :2] for k, v in targets.items()}
    want2, got2, _, _ = _both(outputs, trimmed, False)
    for k in want2:
        assert abs(got[k] - want2[k]) <= 1e-5 * max(abs(want2[k]), 1e-6), k
        assert abs(got2[k] - want2[k]) <= 1e-5 * max(abs(want2[k]), 1e-6), k
