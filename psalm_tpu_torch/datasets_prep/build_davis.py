"""Offline converter: DAVIS-2017 -> trainval_val_psalm.json.

Reference spec: datasets/build_DAVIS.py — per-frame records carrying the
current frame's per-object RLEs plus first_frame_anns/first_frame_image
(:29-106); objects are the unique nonzero values of the indexed
annotation PNGs, kept as category_id (= fill number).
"""

import argparse
import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from psalm_tpu_torch.data import coco_rle


def _frame_anns(png_path: str):
    arr = np.array(Image.open(png_path))
    values = np.unique(arr)
    values = values[values != 0]
    anns = []
    for v in values:
        mask = (arr == v).astype(np.uint8)
        rle = coco_rle.encode(mask)
        anns.append({
            "segmentation": {"counts": rle["counts"].decode("ascii"),
                             "size": rle["size"]},
            "area": float(mask.sum()),
            "category_id": float(v),
        })
    return anns, arr.shape


def build(root: str, split: str = "trainval", image_set: str = "val") -> str:
    ann_root = os.path.join(root, f"2017/{split}/Annotations/480p")
    img_root = os.path.join(root, f"2017/{split}/JPEGImages/480p")
    set_path = os.path.join(root, f"2017/{split}/ImageSets/2017/{image_set}.txt")
    out_path = os.path.join(root, f"2017/{split}_{image_set}_psalm.json")

    with open(set_path) as f:
        videos = [l.strip() for l in f if l.strip()]

    records = []
    new_img_id = 0
    for vid in videos:
        frames = sorted(os.listdir(os.path.join(img_root, vid)))
        ann_frames = sorted(os.listdir(os.path.join(ann_root, vid)))
        first_anns, (H, W) = _frame_anns(
            os.path.join(ann_root, vid, ann_frames[0]))
        first_img_rel = os.path.relpath(
            os.path.join(img_root, vid, frames[0]), root)
        for fname, aname in zip(frames[1:], ann_frames[1:]):
            anns, _ = _frame_anns(os.path.join(ann_root, vid, aname))
            records.append({
                "image": os.path.relpath(os.path.join(img_root, vid, fname),
                                         root),
                "image_info": {"height": H, "width": W, "file_name": fname},
                "new_img_id": new_img_id,
                "anns": anns,
                "first_frame_anns": first_anns,
                "first_frame_image": first_img_rel,
            })
            new_img_id += 1
    with open(out_path, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records to {out_path}")
    return out_path


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="DAVIS root directory")
    p.add_argument("--split", default="trainval")
    p.add_argument("--image_set", default="val")
    a = p.parse_args()
    build(a.root, a.split, a.image_set)
