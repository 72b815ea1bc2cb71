"""Evaluation metrics — PQ, mask AP, IoU meters, semantic mIoU.

The port's copy of ``psalm_tpu/eval/metrics.py`` (held equal by
``tests/test_torch_metrics.py``); the mask IoU runs the native library
(``psalm_tpu_torch/native``).

Self-contained numpy implementations of the metric definitions the reference
delegates to panopticapi / pycocotools / detectron2 evaluators (SURVEY.md
§2.5): panoptic quality per the panopticapi algorithm (match at IoU>0.5 with
void/crowd handling), COCO-style mask AP (IoU thresholds .50:.05:.95, 101-pt
interpolated PR), the cIoU/gIoU accumulators of the referring eval
(referring_segmentation.py:37-79), and histogram-based semantic mIoU
(intersectionAndUnionGPU analog, panoptic_segmentation.py:157-169).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from psalm_tpu_torch import native

VOID = 0


# ---------------------------------------------------------------------------
# Panoptic Quality


@dataclasses.dataclass
class PQStatCat:
    iou: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0


class PQStat:
    def __init__(self):
        self.per_cat: Dict[int, PQStatCat] = defaultdict(PQStatCat)

    def update(self, pred_map: np.ndarray, pred_segments: Sequence[Dict],
               gt_map: np.ndarray, gt_segments: Sequence[Dict]) -> None:
        """One image. Maps are int id maps with 0 = void; segments are dicts
        with id / category_id / (optional) iscrowd."""
        pred_info = {s["id"]: s for s in pred_segments}
        gt_info = {s["id"]: s for s in gt_segments}

        # joint histogram of (gt_id, pred_id) pixel counts
        combined = gt_map.astype(np.uint64) * (2 ** 32) + pred_map.astype(np.uint64)
        ids, counts = np.unique(combined, return_counts=True)
        gt_ids = (ids // (2 ** 32)).astype(np.int64)
        pr_ids = (ids % (2 ** 32)).astype(np.int64)

        gt_areas = defaultdict(int)
        pr_areas = defaultdict(int)
        inter = {}
        for g, p, c in zip(gt_ids, pr_ids, counts):
            gt_areas[int(g)] += int(c)
            pr_areas[int(p)] += int(c)
            inter[(int(g), int(p))] = int(c)

        matched_gt, matched_pred = set(), set()
        for (g, p), c in inter.items():
            if g == VOID or p == VOID:
                continue
            if g not in gt_info or p not in pred_info:
                continue
            if gt_info[g].get("iscrowd", 0):
                continue
            if gt_info[g]["category_id"] != pred_info[p]["category_id"]:
                continue
            # panopticapi subtracts the pred segment's void overlap from the
            # union
            union = (gt_areas[g] + pr_areas[p] - c - inter.get((VOID, p), 0))
            if union > 0 and c / union > 0.5:
                cat = gt_info[g]["category_id"]
                self.per_cat[cat].iou += c / union
                self.per_cat[cat].tp += 1
                matched_gt.add(g)
                matched_pred.add(p)

        crowd_by_cat = {gt_info[g]["category_id"]: g for g in gt_info
                        if gt_info[g].get("iscrowd", 0)}
        for g, info in gt_info.items():
            if g in matched_gt or info.get("iscrowd", 0):
                continue
            self.per_cat[info["category_id"]].fn += 1
        for p, info in pred_info.items():
            if p in matched_pred:
                continue
            # ignore preds mostly covered by void + same-class crowd
            ignore = inter.get((VOID, p), 0)
            crowd_g = crowd_by_cat.get(info["category_id"])
            if crowd_g is not None:
                ignore += inter.get((crowd_g, p), 0)
            if pr_areas.get(p, 0) and ignore / pr_areas[p] > 0.5:
                continue
            self.per_cat[info["category_id"]].fp += 1

    def summarize(self, categories: Optional[Dict[int, Dict]] = None
                  ) -> Dict[str, float]:
        def agg(cats):
            pq = sq = rq = 0.0
            n = 0
            for c in cats:
                s = self.per_cat[c]
                if s.tp + s.fp + s.fn == 0:
                    continue
                n += 1
                pq += s.iou / (s.tp + 0.5 * s.fp + 0.5 * s.fn)
                sq += s.iou / s.tp if s.tp else 0.0
                rq += s.tp / (s.tp + 0.5 * s.fp + 0.5 * s.fn)
            if n == 0:
                return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
            return {"pq": 100 * pq / n, "sq": 100 * sq / n,
                    "rq": 100 * rq / n, "n": n}

        cats = list(self.per_cat.keys())
        out = {"All": agg(cats)}
        if categories is not None:
            out["Things"] = agg([c for c in cats
                                 if categories.get(c, {}).get("isthing")])
            out["Stuff"] = agg([c for c in cats
                                if not categories.get(c, {}).get("isthing")])
        return out


# ---------------------------------------------------------------------------
# COCO-style mask AP


IOU_THRS = np.arange(0.5, 1.0, 0.05)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def mask_iou_matrix(pred_masks: np.ndarray, gt_masks: np.ndarray,
                    iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """[P, H, W] x [G, H, W] bool -> IoU [P, G]; crowd gt uses IoA."""
    P, G = len(pred_masks), len(gt_masks)
    if P == 0 or G == 0:
        return np.zeros((P, G))
    return native.mask_iou_matrix(np.asarray(pred_masks, np.uint8),
                                  np.asarray(gt_masks, np.uint8), iscrowd)


class InstanceAPEvaluator:
    """Accumulates per-image detections and computes segm mAP (all-area,
    maxDets=100), matching the COCOeval matching rules."""

    def __init__(self, category_ids: Sequence[int]):
        self.category_ids = list(category_ids)
        # per cat: list of (score, matched@thr[T]) and total gt count
        self.dets: Dict[int, List[Tuple[float, np.ndarray]]] = defaultdict(list)
        self.n_gt: Dict[int, int] = defaultdict(int)

    def add_image(self, pred_masks, pred_scores, pred_classes,
                  gt_masks, gt_classes, gt_iscrowd=None) -> None:
        pred_masks = np.asarray(pred_masks, bool)
        gt_masks = np.asarray(gt_masks, bool)
        gt_iscrowd = (np.zeros(len(gt_masks), bool) if gt_iscrowd is None
                      else np.asarray(gt_iscrowd, bool))
        for cat in set(list(pred_classes) + list(gt_classes)):
            p_idx = [i for i, c in enumerate(pred_classes) if c == cat]
            g_idx = [i for i, c in enumerate(gt_classes) if c == cat]
            p_idx = sorted(p_idx, key=lambda i: -pred_scores[i])[:100]
            g_crowd = gt_iscrowd[g_idx]
            self.n_gt[cat] += int((~g_crowd).sum())
            if not p_idx:
                continue
            ious = mask_iou_matrix(pred_masks[p_idx], gt_masks[g_idx], g_crowd)
            T = len(IOU_THRS)
            G = len(g_idx)
            gt_taken = np.zeros((T, G), bool)
            for pi, i in enumerate(p_idx):
                matched = np.zeros(T, bool)
                for t, thr in enumerate(IOU_THRS):
                    best, best_g = thr, -1
                    for gj in range(G):
                        if gt_taken[t, gj] and not g_crowd[gj]:
                            continue
                        if ious[pi, gj] >= best:
                            best = ious[pi, gj]
                            best_g = gj
                    if best_g >= 0:
                        if not g_crowd[best_g]:
                            gt_taken[t, best_g] = True
                            matched[t] = True
                        else:
                            matched[t] = True  # crowd match: ignore, counts as TP-ignore
                self.dets[cat].append((float(pred_scores[i]), matched))

    def summarize(self) -> Dict[str, float]:
        T = len(IOU_THRS)
        ap_per_cat = []
        ap50_per_cat = []
        ap75_per_cat = []
        for cat in self.category_ids:
            if self.n_gt[cat] == 0:
                continue
            dets = sorted(self.dets[cat], key=lambda x: -x[0])
            if not dets:
                ap_per_cat.append(0.0)
                ap50_per_cat.append(0.0)
                ap75_per_cat.append(0.0)
                continue
            matched = np.stack([m for _, m in dets])  # [D, T]
            tps = np.cumsum(matched, 0)
            fps = np.cumsum(~matched, 0)
            ap_t = []
            for t in range(T):
                rc = tps[:, t] / self.n_gt[cat]
                pr = tps[:, t] / np.maximum(tps[:, t] + fps[:, t], 1e-9)
                # monotone precision envelope + 101-pt interpolation
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                idx = np.searchsorted(rc, RECALL_THRS, side="left")
                q = np.where(idx < len(pr), pr[np.minimum(idx, len(pr) - 1)], 0)
                ap_t.append(q.mean())
            ap_per_cat.append(float(np.mean(ap_t)))
            ap50_per_cat.append(float(ap_t[0]))
            ap75_per_cat.append(float(ap_t[5]))
        if not ap_per_cat:
            return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
        return {"AP": 100 * float(np.mean(ap_per_cat)),
                "AP50": 100 * float(np.mean(ap50_per_cat)),
                "AP75": 100 * float(np.mean(ap75_per_cat))}


# ---------------------------------------------------------------------------
# referring / interactive IoU meters


class IoUMeter:
    """cIoU (cumulative) + gIoU (mean of per-sample IoU), as the reference's
    AverageMeter pair (referring_segmentation.py:37-79)."""

    def __init__(self):
        self.inter = 0.0
        self.union = 0.0
        self.per_sample: List[float] = []

    def update(self, pred: np.ndarray, gt: np.ndarray) -> float:
        pred = np.asarray(pred, bool)
        gt = np.asarray(gt, bool)
        i = float(np.logical_and(pred, gt).sum())
        u = float(np.logical_or(pred, gt).sum())
        self.inter += i
        self.union += u
        iou = i / u if u > 0 else 0.0
        self.per_sample.append(iou)
        return iou

    @property
    def ciou(self) -> float:
        return 100 * self.inter / self.union if self.union else 0.0

    @property
    def giou(self) -> float:
        return 100 * float(np.mean(self.per_sample)) if self.per_sample else 0.0


# ---------------------------------------------------------------------------
# semantic mIoU


class SemSegMeter:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.inter = np.zeros(num_classes)
        self.union = np.zeros(num_classes)
        self.target = np.zeros(num_classes)

    def update(self, pred: np.ndarray, gt: np.ndarray) -> None:
        mask = gt != self.ignore_label
        pred = pred[mask]
        gt = gt[mask]
        match = pred == gt
        self.inter += np.bincount(pred[match], minlength=self.num_classes)[
            :self.num_classes]
        self.union += (np.bincount(pred, minlength=self.num_classes)
                       + np.bincount(gt, minlength=self.num_classes)
                       )[:self.num_classes]
        self.target += np.bincount(gt, minlength=self.num_classes)[
            :self.num_classes]

    def summarize(self) -> Dict[str, float]:
        union = self.union - self.inter
        valid = self.target > 0
        iou = np.where(union > 0, self.inter / np.maximum(union, 1e-9), 0.0)
        acc = np.where(self.target > 0,
                       self.inter / np.maximum(self.target, 1e-9), 0.0)
        return {"mIoU": 100 * float(iou[valid].mean()) if valid.any() else 0.0,
                "mAcc": 100 * float(acc[valid].mean()) if valid.any() else 0.0}
