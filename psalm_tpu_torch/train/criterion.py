"""PSALM training criterion: Hungarian-matched set losses.

Counterpart of ``psalm_tpu/train/criterion.py`` (behavioral spec: the
reference's PSALM_criterion and hungarian_matcher_PSALM):

  * matcher cost = 2 * (-softmax class probability) + 5 * point-sampled
    sigmoid CE + 5 * point-sampled dice, over a uniform random point set
    shared by the image's masks; one assignment call for every layer of the
    step, as JAX batches it, by the matcher ``set_assign_impl`` selects
    (JAX's ``criterion.py:88-127``): ``"scipy"`` (the default, as JAX picks
    it wherever host callbacks exist), scipy's ``linear_sum_assignment`` on
    the host (``_lsa_host``, a copy of JAX's, held equal by
    ``tests/test_torch_copies.py``; one device-to-host copy a step);
    ``"lap"``, the exact on-device solver (``train/lap.py``, kernel K6 on
    the card); ``"auction"``, the approximate one (``train/auction.py``,
    K7). The two on-device matchers copy nothing to the host;
  * mask losses: 12544 points by uncertainty sampling (oversample 3.0,
    importance 0.75), sigmoid CE mean plus dice; by default the uncertainty
    point set is shared by an image's matched masks (JAX's default), with
    ``per_mask_uncertainty=True`` the reference's per-mask sampling;
  * [SEG] loss: BCE with pos_weight over the query-selection targets;
  * class-name loss: weighted CE, background (the last class) weight 0.1;
  * region loss: BCE with pos_weight on the [R, Q] region-query matrix;
  * ``__call__`` sums the weighted components over the final and the aux
    layers.

Targets are padded to N masks with a validity mask: invalid columns cost
1e8, so the assignment never picks them, and their losses are masked out.

Random points come from ``uniform_fn(generator, shape)`` (default
``torch.rand`` on the generator's device); the tests inject the same draws
on both sides, as JAX's ``uniform_fn`` hook lets them.

With a ``mesh`` (``parallel/mesh.py``), each data rank holds its rows of the
global batch that JAX's step sees whole, and the criterion returns this
rank's share of the global losses, so that the shares sum over the data
group to the one-process losses of the concatenated batch (and their
gradients to its gradient): ``num_masks`` is the global count of valid
masks (``psalm_tpu/train/criterion.py:376-380``), the [SEG] and region
losses are means over the global number of entries with the global
``pos_weight``, the class-name loss divides by the global sum of its
weights, and the points are the global draws' rows of this rank
(``shard_draws``).

One deliberate difference: JAX writes the matched class labels with
``.at[src].set`` over every target slot, padding included, so a padding slot
(query index 0, background) written after a valid target matched to query 0
overwrites that target's label; the port scatters the valid pairs only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from psalm_tpu_torch.config import LossConfig
from psalm_tpu_torch.ops.sampling import (UniformFn, default_uniform,
                                          point_sample)
from psalm_tpu_torch.parallel.mesh import all_reduce, shard_draws
from psalm_tpu_torch.spans import spanned
from psalm_tpu_torch.train.auction import auction_assign
from psalm_tpu_torch.train.lap import lap_assign


# ---------------------------------------------------------------------------
# batched cost kernels: [..., Q, P] x [..., N, P] -> [..., Q, N]


def batch_sigmoid_ce_cost(inputs: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    P = inputs.shape[-1]
    pos = F.softplus(-inputs)  # BCE(x, 1)
    neg = F.softplus(inputs)   # BCE(x, 0)
    return (pos @ targets.transpose(-1, -2)
            + neg @ (1.0 - targets).transpose(-1, -2)) / P


def batch_dice_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    probs = torch.sigmoid(inputs)
    numerator = 2.0 * (probs @ targets.transpose(-1, -2))
    denominator = probs.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


# ---------------------------------------------------------------------------
# Hungarian assignment: on the host or on the device


def _lsa_host(cost: np.ndarray, n_valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cost: [B, Q, N]; n_valid: [B]. Returns src (query) and tgt indices
    [B, N] padded with -1 beyond n_valid."""
    B, Q, N = cost.shape
    src = np.full((B, N), -1, np.int32)
    tgt = np.full((B, N), -1, np.int32)
    for b in range(B):
        n = int(n_valid[b])
        if n == 0:
            continue
        c = np.nan_to_num(np.asarray(cost[b, :, :n], np.float64),
                          nan=1e8, posinf=1e8, neginf=-1e8)
        rows, cols = linear_sum_assignment(c)
        src[b, :n] = rows[np.argsort(cols)]
        tgt[b, :n] = np.arange(n)
    return src, tgt


_ASSIGN_IMPL = "scipy"  # "scipy" (host), "lap" or "auction" (on the device)


def _assign_impl() -> str:
    """The matcher ``hungarian_assign`` runs. JAX probes for host callbacks
    and falls back to ``"lap"`` where they fail; PyTorch always reaches the
    host, so the default stays ``"scipy"``."""
    return _ASSIGN_IMPL


def set_assign_impl(name: str) -> None:
    global _ASSIGN_IMPL
    assert name in ("scipy", "lap", "auction")
    _ASSIGN_IMPL = name


@spanned("criterion.match")
def hungarian_assign(cost: torch.Tensor, n_valid: torch.Tensor):
    """(src_idx [B, N] long, valid [B, N] bool) on cost's device: target j
    (j < n_valid[b]) is matched to query src_idx[b, j]; 0 elsewhere. With
    ``"scipy"`` one host round trip (the reference's own device-to-CPU
    hop); ``"lap"`` and ``"auction"`` stay on cost's device."""
    cost = cost.detach()
    impl = _assign_impl()
    if impl == "lap":
        return lap_assign(cost, n_valid)
    if impl == "auction":
        return auction_assign(cost, n_valid)
    src, _ = _lsa_host(cost.float().cpu().numpy(),
                       n_valid.detach().cpu().numpy())
    src = torch.from_numpy(src).to(cost.device)
    valid = src >= 0
    return torch.where(valid, src, torch.zeros_like(src)).long(), valid


# ---------------------------------------------------------------------------
# uncertainty point sampling (point_rend's get_uncertain_point_coords_with_
# randomness)


def uncertain_point_coords(generator: torch.Generator, logits_fn,
                           num_points: int, oversample_ratio: float,
                           importance_sample_ratio: float, batch: int,
                           uniform_fn: UniformFn = default_uniform
                           ) -> torch.Tensor:
    """[batch, num_points, 2] coords in [0, 1]. logits_fn(coords [batch, S,
    2]) -> [batch, S] mask logits at the coords; uncertainty = -|logit|."""
    n_sampled = int(num_points * oversample_ratio)
    coords = uniform_fn(generator, (batch, n_sampled, 2))
    uncertainty = -logits_fn(coords).abs()
    n_unc = int(importance_sample_ratio * num_points)
    idx = torch.topk(uncertainty, n_unc, dim=1).indices
    top = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
    rand = uniform_fn(generator, (batch, num_points - n_unc, 2))
    return torch.cat([top, rand.to(top.device)], dim=1)


def _sample_mask_at(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks [B, H, W]; coords [B, P, 2] -> [B, P]."""
    return point_sample(masks[..., None], coords)[..., 0]


def _mask_losses(point_logits, point_labels, valid, num_masks):
    """Sigmoid CE mean and dice per mask [B*N, P], summed over the valid
    masks and divided by num_masks."""
    v = valid.reshape(-1).float()
    ce = F.softplus(point_logits) - point_logits * point_labels
    loss_mask = torch.sum(ce.mean(-1) * v) / num_masks
    probs = torch.sigmoid(point_logits)
    numerator = 2.0 * torch.sum(probs * point_labels, -1)
    denominator = probs.sum(-1) + point_labels.sum(-1)
    dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    return loss_mask, torch.sum(dice * v) / num_masks


def _bce_pos_weight(logits, tgt, pos_weight):
    """BCEWithLogits(pos_weight), mean: pw*y*softplus(-x) + (1-y)*softplus(x)."""
    return (pos_weight * tgt * F.softplus(-logits)
            + (1 - tgt) * F.softplus(logits)).mean()


class PSALMCriterion:
    """Call with the model's outputs (final layer plus ``aux_outputs``) and
    targets: masks [B, N, H, W] {0, 1}, labels [B, N] int, valid [B, N]
    bool."""

    def __init__(self, cfg: LossConfig, num_queries: int,
                 per_mask_uncertainty: bool = False,
                 uniform_fn: UniformFn = default_uniform, mesh=None):
        self.cfg = cfg
        self.num_queries = num_queries
        self.per_mask_uncertainty = per_mask_uncertainty
        self.mesh = mesh
        self.data = 1 if mesh is None else mesh.data
        self.uniform_fn = (uniform_fn if mesh is None
                           else shard_draws(uniform_fn, mesh))

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group (``t`` without a mesh)."""
        return t if self.mesh is None else all_reduce(t, self.mesh.data_group)

    def _uniform(self, generator, shape, device) -> torch.Tensor:
        return torch.as_tensor(self.uniform_fn(generator, shape),
                               dtype=torch.float32, device=device)

    # -- matching ----------------------------------------------------------

    def match_cost(self, generator, outputs, targets
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One layer's assignment cost [B, Q, N] and n_valid [B]. All Q (and
        N) masks are sampled at the image's shared points in one gather."""
        c = self.cfg
        pred_masks = outputs["pred_masks"].float()
        B, Q = pred_masks.shape[:2]
        dev = pred_masks.device
        coords = self._uniform(generator, (B, c.train_num_points, 2), dev)
        out_pts = point_sample(pred_masks.permute(0, 2, 3, 1),
                               coords).transpose(1, 2)  # [B, Q, P]
        tgt_pts = point_sample(targets["masks"].float().permute(0, 2, 3, 1),
                               coords).transpose(1, 2)  # [B, N, P]
        cost = (c.mask_weight * batch_sigmoid_ce_cost(out_pts, tgt_pts)
                + c.dice_weight * batch_dice_cost(out_pts, tgt_pts))
        logits = outputs.get("pred_class_name_logits")
        if logits is not None:
            prob = torch.softmax(logits.float(), -1)
            labels = targets["labels"].long().clamp(0, prob.shape[-1] - 1)
            cost = cost - c.class_weight * torch.gather(
                prob, 2, labels[:, None, :].expand(-1, Q, -1))
        valid = targets["valid"].bool()
        cost = torch.where(valid[:, None, :], cost,
                           torch.full_like(cost, 1e8))
        return cost, valid.sum(-1)

    def match(self, generator, outputs, targets):
        """(src_idx, valid) of one prediction layer."""
        return hungarian_assign(*self.match_cost(generator, outputs, targets))

    # -- per-loss terms ------------------------------------------------------

    def loss_masks(self, generator, outputs, targets, src_idx, valid,
                   num_masks):
        """Point-sampled mask losses of the matched masks."""
        c = self.cfg
        pred = outputs["pred_masks"].float()
        B, Q, h, w = pred.shape
        N = src_idx.shape[1]
        src_masks = torch.gather(pred, 1, src_idx[:, :, None, None].expand(
            -1, -1, h, w))  # [B, N, h, w]
        tgt_masks = targets["masks"].float()
        dev = pred.device
        P = c.train_num_points

        if not self.per_mask_uncertainty:
            n_sampled = int(P * c.oversample_ratio)
            n_unc = int(c.importance_sample_ratio * P)
            pred_chan = src_masks.permute(0, 2, 3, 1)  # [B, h, w, N]
            probe = self._uniform(generator, (B, n_sampled, 2), dev)
            with torch.no_grad():
                logits0 = point_sample(pred_chan, probe)  # [B, S, N]
                unc = torch.where(valid[:, None, :], -logits0.abs(),
                                  torch.full_like(logits0, -torch.inf)
                                  ).amax(-1)  # [B, S]
                idx = torch.topk(unc, n_unc, dim=1).indices
                top = torch.gather(probe, 1, idx[..., None].expand(-1, -1, 2))
                rand = self._uniform(generator, (B, P - n_unc, 2), dev)
                coords = torch.cat([top, rand], dim=1)  # [B, P, 2]
                point_labels = point_sample(tgt_masks.permute(0, 2, 3, 1),
                                            coords).transpose(1, 2)
            point_logits = point_sample(pred_chan, coords).transpose(1, 2)
            return _mask_losses(point_logits.reshape(B * N, P),
                                point_labels.reshape(B * N, P), valid,
                                num_masks)

        sm = src_masks.reshape(B * N, h, w)
        tm = tgt_masks.reshape(B * N, *tgt_masks.shape[2:])
        with torch.no_grad():
            coords = uncertain_point_coords(
                generator, lambda xy: _sample_mask_at(sm, xy), P,
                c.oversample_ratio, c.importance_sample_ratio, B * N,
                uniform_fn=lambda g, shape: self._uniform(g, shape, dev))
            point_labels = _sample_mask_at(tm, coords)
        return _mask_losses(_sample_mask_at(sm, coords), point_labels, valid,
                            num_masks)

    def loss_seg_labels(self, outputs, src_idx, valid, num_masks):
        logits = outputs.get("pred_SEG_logits")
        if logits is None:
            return None
        logits = logits.float()[..., 0]  # [B, Q]
        B, Q = logits.shape
        tgt = torch.zeros(B, Q, device=logits.device).scatter_reduce(
            1, src_idx, valid.float(), reduce="amax")
        n = B * Q * self.data
        return _bce_pos_weight(logits, tgt,
                               (n - num_masks) / num_masks) / self.data

    def loss_class_name_labels(self, outputs, targets, src_idx, valid):
        logits = outputs.get("pred_class_name_logits")
        if logits is None:
            return None
        logits = logits.float()
        B, Q, K = logits.shape
        # matched queries take their target's label, the rest background
        tgt_classes = torch.full((B, Q), K - 1, dtype=torch.long,
                                 device=logits.device)
        b, j = valid.nonzero(as_tuple=True)
        tgt_classes[b, src_idx[b, j]] = targets["labels"].long()[b, j]
        weights = torch.ones(K, device=logits.device)
        weights[K - 1] = 0.1
        nll = -torch.gather(torch.log_softmax(logits, -1), 2,
                            tgt_classes[..., None])[..., 0]
        wt = weights[tgt_classes]
        return torch.sum(nll * wt) / self.global_sum(torch.sum(wt))

    def loss_region_labels(self, outputs, src_idx, valid, num_masks):
        logits = outputs.get("pred_region_logits")
        if logits is None:
            return None
        logits = logits.float()  # [B, R, Q]
        B, R, Q = logits.shape
        # target[b, j, src_idx[b, j]] = 1 for the valid matched pairs
        tgt = torch.zeros(B, R, Q, device=logits.device).scatter_reduce(
            2, src_idx[:, :R, None], valid[:, :R, None].float(), reduce="amax")
        n = B * R * Q * self.data
        return _bce_pos_weight(logits, tgt,
                               (n - num_masks) / num_masks) / self.data

    # -- full forward --------------------------------------------------------

    def __call__(self, generator: torch.Generator, outputs: Dict,
                 targets: Dict, compute_seg: bool = False,
                 compute_class: bool = True,
                 compute_region: bool = False) -> Dict[str, torch.Tensor]:
        """The weighted components summed over the final and aux layers, and
        their sum ``loss_total``. Points are drawn in JAX's order: every
        layer's matching points, then each layer's mask-loss points."""
        c = self.cfg
        dev = outputs["pred_masks"].device
        num_masks = self.global_sum(
            targets["valid"].sum().float()).clamp(min=1.0)
        layers = [outputs] + list(outputs.get("aux_outputs", []))
        zero = torch.zeros((), device=dev)
        totals = {k: zero for k in ("loss_mask", "loss_dice", "loss_SEG_class",
                                    "loss_class_name_class",
                                    "loss_region_class")}
        # one assignment for all layers: [L*B, Q, N]
        costs, n_valid = [], None
        for layer_out in layers:
            cost, n_valid = self.match_cost(generator, layer_out, targets)
            costs.append(cost)
        B = costs[0].shape[0]
        src_all, valid_all = hungarian_assign(torch.cat(costs, 0),
                                              n_valid.repeat(len(layers)))
        for li, layer_out in enumerate(layers):
            src_idx = src_all[li * B:(li + 1) * B]
            valid = valid_all[li * B:(li + 1) * B]
            lm, ld = self.loss_masks(generator, layer_out, targets, src_idx,
                                     valid, num_masks)
            totals["loss_mask"] = totals["loss_mask"] + c.mask_weight * lm
            totals["loss_dice"] = totals["loss_dice"] + c.dice_weight * ld
            for key, on, loss in (
                    ("loss_SEG_class", compute_seg, lambda: self.loss_seg_labels(
                        layer_out, src_idx, valid, num_masks)),
                    ("loss_class_name_class", compute_class,
                     lambda: self.loss_class_name_labels(layer_out, targets,
                                                         src_idx, valid)),
                    ("loss_region_class", compute_region,
                     lambda: self.loss_region_labels(layer_out, src_idx, valid,
                                                     num_masks))):
                value = loss() if on else None
                if value is not None:
                    totals[key] = totals[key] + c.class_weight * value
        totals["loss_total"] = sum(totals.values())
        return totals
