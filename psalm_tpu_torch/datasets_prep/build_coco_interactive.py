"""Offline converter: synthesize COCO-Interactive visual prompts.

Reference spec: datasets/bulid_COCO_Interactivate.py (generate_visual_prompt
:27-143) — for each instance mask, per connected component with area > 5:
  point    — up to 1000 tries: a point at centroid + polar offset with
             radius U(0, min(bbox_h, bbox_w) * 0.5) (two INDEPENDENT radius
             draws for the row/col components, the reference's quirk),
             clipped to the bbox, accepted when inside the mask (:38-49);
  mask     — gaussian_filter(mask, sigma=2) thresholded strictly above the
             blurred image's MEAN (:52-53);
  box      — the component bbox scaled by ONE factor U(0.9, 1.1) about its
             center (int-truncated edges), painted as a filled rectangle
             (:56-72);
  scribble — a box with dims scaled U(0.5, 1.2) about the centroid,
             re-sampled up to 1000 times until IoU >= 0.5 with the original
             bbox (else the component is skipped); a Bresenham line between
             a random corner and its opposite corner, with a sine wave
             (amplitude U(10, 20), frequency U(0.2, 1), phase U(0, 2*pi))
             added to the row coordinates (:75-141). NOT intersected with
             the gt mask, exactly like the reference.

The reference uses skimage.measure.label (full connectivity) + regionprops;
re-derived here with cv2 connected components (8-connectivity) since skimage
is not in this image. Draws use numpy RNG with the same distributions.
"""

import argparse
import json
import sys
import os

import numpy as np
from scipy.ndimage import gaussian_filter

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from psalm_tpu_torch.data import coco_rle


def _rle(mask):
    r = coco_rle.encode(mask.astype(np.uint8))
    return {"size": r["size"], "counts": r["counts"].decode("ascii")}


def _components(mask, min_area=5):
    """Connected components (8-connectivity, like skimage full connectivity)
    with skimage-style props: bbox (min_row, min_col, max_row, max_col —
    max exclusive) and centroid (row, col). Components with area <= min_area
    are dropped (reference :31-33)."""
    import cv2
    n, labels, stats, centroids = cv2.connectedComponentsWithStats(
        mask.astype(np.uint8), connectivity=8)
    props = []
    for i in range(1, n):
        area = int(stats[i, cv2.CC_STAT_AREA])
        if area <= min_area:
            continue
        x, y = int(stats[i, cv2.CC_STAT_LEFT]), int(stats[i, cv2.CC_STAT_TOP])
        w, h = int(stats[i, cv2.CC_STAT_WIDTH]), int(stats[i, cv2.CC_STAT_HEIGHT])
        props.append({
            "bbox": (y, x, y + h, x + w),
            "centroid": (float(centroids[i][1]), float(centroids[i][0])),
            "area": area,
        })
    return props


def _box_iou_rowcol(box1, box2):
    """IoU in the reference's (min_row, min_col, max_row, max_col) layout —
    including its +1 inclusive-pixel convention (calculate_iou :13-25)."""
    xA = max(box1[1], box2[1])
    yA = max(box1[0], box2[0])
    xB = min(box1[3], box2[3])
    yB = min(box1[2], box2[2])
    inter = max(0, xB - xA + 1) * max(0, yB - yA + 1)
    a1 = (box1[2] - box1[0] + 1) * (box1[3] - box1[1] + 1)
    a2 = (box2[2] - box2[0] + 1) * (box2[3] - box2[1] + 1)
    return inter / float(a1 + a2 - inter)


def _line(r0, c0, r1, c1):
    """Bresenham line (skimage.draw.line semantics): integer pixel chain
    from (r0, c0) to (r1, c1) inclusive."""
    steep = abs(r1 - r0) > abs(c1 - c0)
    if steep:
        r0, c0, r1, c1 = c0, r0, c1, r1
    swapped = c0 > c1
    if swapped:
        r0, c0, r1, c1 = r1, c1, r0, c0
    dc = c1 - c0
    dr = abs(r1 - r0)
    err = dc / 2.0
    rstep = 1 if r0 < r1 else -1
    rr, cc = [], []
    r = r0
    for c in range(c0, c1 + 1):
        rr.append(c if steep else r)
        cc.append(r if steep else c)
        err -= dr
        if err < 0:
            r += rstep
            err += dc
    if swapped:
        rr, cc = rr[::-1], cc[::-1]
    return np.asarray(rr), np.asarray(cc)


def point_prompt(mask, rng):
    """Reference :36-49."""
    out = np.zeros_like(mask, np.uint8)
    for prop in _components(mask):
        min_row, min_col, max_row, max_col = prop["bbox"]
        cy, cx = prop["centroid"]
        radius = min(max_row - min_row, max_col - min_col) * 0.5
        for _ in range(1000):
            angle = rng.uniform(0, 2 * np.pi)
            # two independent radius draws — the reference's exact quirk
            off_r = rng.uniform(0, radius) * np.cos(angle)
            off_c = rng.uniform(0, radius) * np.sin(angle)
            pr = int(np.clip(int(cy + off_r), min_row, max_row - 1))
            pc = int(np.clip(int(cx + off_c), min_col, max_col - 1))
            if mask[pr, pc] > 0:
                out[pr, pc] = 1
                break
    return out


def mask_prompt(mask, rng=None, sigma=2):
    """Reference :52-53: blur sigma=2, threshold strictly above the MEAN."""
    blurred = gaussian_filter(mask.astype(float), sigma=sigma)
    return (blurred > blurred.mean()).astype(np.uint8)


def box_prompt(mask, rng):
    """Reference :56-72: one U(0.9, 1.1) scale about the bbox center."""
    out = np.zeros_like(mask, np.uint8)
    H, W = mask.shape
    for prop in _components(mask):
        min_row, min_col, max_row, max_col = prop["bbox"]
        scale = rng.uniform(0.9, 1.1)
        dh = (max_row - min_row) * (scale - 1)
        dw = (max_col - min_col) * (scale - 1)
        r0 = max(0, int(min_row - dh / 2))
        c0 = max(0, int(min_col - dw / 2))
        r1 = min(H, int(max_row + dh / 2))
        c1 = min(W, int(max_col + dw / 2))
        out[r0:r1, c0:c1] = 1
    return out


def scribble_prompt(mask, rng):
    """Reference :75-141."""
    out = np.zeros_like(mask, np.uint8)
    H, W = mask.shape
    for prop in _components(mask):
        min_row, min_col, max_row, max_col = prop["bbox"]
        cy, cx = prop["centroid"]
        original = (min_row, min_col, max_row, max_col)

        def sample_box():
            nh = (max_row - min_row) * rng.uniform(0.5, 1.2)
            nw = (max_col - min_col) * rng.uniform(0.5, 1.2)
            r0 = max(int(cy - nh / 2), 0)
            c0 = max(int(cx - nw / 2), 0)
            r1 = min(int(cy + nh / 2), H)
            c1 = min(int(cx + nw / 2), W)
            return (r0, c0, r1, c1)

        box = sample_box()
        ok = _box_iou_rowcol(box, original) >= 0.5
        for _ in range(1000):
            if ok:
                break
            box = sample_box()
            ok = _box_iou_rowcol(box, original) >= 0.5
        if not ok:
            continue
        r0, c0, r1, c1 = box
        corners = [(r0, c0), (r0, c1), (r1, c0), (r1, c1)]
        start = corners[rng.integers(len(corners))]
        # opposite corner (reference :121-127)
        if start in [(r0, c0), (r1, c1)]:
            end = (r1 if start[0] == r0 else r0, c1 if start[1] == c0 else c0)
        else:
            end = (r1 if start[0] == r0 else r0, c0 if start[1] == c1 else c1)
        rr, cc = _line(start[0], start[1], end[0], end[1])
        rr = rr.astype(np.float32)
        amplitude = rng.uniform(10, 20)
        frequency = rng.uniform(0.2, 1)
        phase = rng.uniform(0, 2 * np.pi)
        rr = rr + amplitude * np.sin(
            2 * np.pi * frequency * np.linspace(0, 1, len(rr)) + phase)
        rr = np.clip(rr, 0, H - 1).astype(np.int32)
        cc = np.clip(cc, 0, W - 1).astype(np.int32)
        out[rr, cc] = 1
    return out


def build(instance_json: str, out_path: str, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    with open(instance_json) as f:
        records = json.load(f)
    kept = []
    for rec in records:
        H = rec["image_info"]["height"]
        W = rec["image_info"]["width"]
        new_anns = []
        for ann in rec["anns"]:
            seg = ann["segmentation"]
            if isinstance(seg, dict):
                mask = coco_rle.decode(seg)
            else:
                mask = coco_rle.merge_polygons_to_mask(seg, H, W)
            if mask.sum() == 0:
                continue
            prompts = {
                "point_visual_prompt_mask": point_prompt(mask, rng),
                "mask_visual_prompt_mask": mask_prompt(mask, rng),
                "box_visual_prompt_mask": box_prompt(mask, rng),
                "scribble_visual_prompt_mask": scribble_prompt(mask, rng),
            }
            if any(v is None or v.sum() == 0 for v in prompts.values()):
                continue
            new_anns.append({**ann,
                             **{k: _rle(v) for k, v in prompts.items()}})
        if new_anns:
            kept.append({**rec, "anns": new_anns})
    with open(out_path, "w") as f:
        json.dump(kept, f)
    print(f"wrote {len(kept)} records to {out_path}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--instance_json", required=True,
                   help="output of build_coco_instance.py")
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    build(a.instance_json, a.out, a.seed)
