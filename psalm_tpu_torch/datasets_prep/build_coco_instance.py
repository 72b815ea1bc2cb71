"""Offline converter: COCO instances_{split}.json -> instance_{split}_psalm.json.

Reference spec: datasets/build_COCO_instance.py — group annotations per image
and assign a sequential new_img_id (:37-60).
"""

import argparse
import json
import os
from collections import defaultdict


def build(instances_json: str, out_path: str) -> None:
    with open(instances_json) as f:
        coco = json.load(f)
    imgs = {im["id"]: im for im in coco["images"]}
    per_image = defaultdict(list)
    for ann in coco["annotations"]:
        per_image[ann["image_id"]].append(ann)

    records = []
    new_img_id = 0
    for image_id, anns in per_image.items():
        im = imgs[image_id]
        records.append({
            "image": im["file_name"],
            "image_info": {"height": im["height"], "width": im["width"],
                           "file_name": im["file_name"]},
            "new_img_id": new_img_id,
            "anns": anns,
        })
        new_img_id += 1
    with open(out_path, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records to {out_path}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--instances_json", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    build(a.instances_json, a.out)
