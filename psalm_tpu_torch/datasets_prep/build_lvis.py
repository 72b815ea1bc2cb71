"""Offline converter: LVIS v1 -> lvis_instance_psalm.json + categories file.

Reference spec: datasets/bulid_lvis.py — group LVIS anns per image with
new_img_id and dump the category table (:14-21)."""

import argparse
import json
from collections import defaultdict


def build(lvis_json: str, out_path: str, categories_out: str) -> None:
    with open(lvis_json) as f:
        lvis = json.load(f)
    with open(categories_out, "w") as f:
        json.dump(lvis["categories"], f)
    imgs = {im["id"]: im for im in lvis["images"]}
    per_image = defaultdict(list)
    for ann in lvis["annotations"]:
        per_image[ann["image_id"]].append(ann)
    records = []
    for new_img_id, (image_id, anns) in enumerate(per_image.items()):
        im = imgs[image_id]
        # LVIS v1 stores the split inside coco_url
        fname = im["coco_url"].split("/")[-1]
        records.append({
            "image": fname,
            "image_info": {"height": im["height"], "width": im["width"],
                           "file_name": fname},
            "new_img_id": new_img_id,
            "anns": anns,
        })
    with open(out_path, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records to {out_path}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--lvis_json", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--categories_out", required=True)
    a = p.parse_args()
    build(a.lvis_json, a.out, a.categories_out)
