"""The set criterion of the reference: a frozen copy of the port's
``train/criterion.py`` with scipy's matcher only (the port's default). With
a ``mesh`` (any object with ``data``, ``data_rank`` and ``data_group``),
each rank holds its rows and the counts are summed over the group, as the
port's data-parallel criterion does."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from h100_bench.reference.config import LossConfig
from h100_bench.reference.sampling import (UniformFn, default_uniform,
                                          point_sample)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, as a new tensor outside the graph."""
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def shard_draws(uniform_fn: UniformFn, mesh) -> UniformFn:
    """Draws of the global batch, this data rank's rows kept."""
    def draw(generator, shape):
        B = shape[0]
        full = uniform_fn(generator, (B * mesh.data, *shape[1:]))
        return full[mesh.data_rank * B:(mesh.data_rank + 1) * B]
    return draw


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


def hungarian_assign(cost: torch.Tensor, n_valid: torch.Tensor):
    """(src_idx [B, N] long, valid [B, N] bool) on cost's device: target j
    (j < n_valid[b]) is matched to query src_idx[b, j]; 0 elsewhere. With
    ``"scipy"`` one host round trip (the reference's own device-to-CPU
    hop); ``"lap"`` and ``"auction"`` stay on cost's device."""
    cost = cost.detach()
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
