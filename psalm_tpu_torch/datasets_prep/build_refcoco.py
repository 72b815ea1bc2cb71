"""Offline converter: RefCOCO/RefCOCO+/RefCOCOg refs pickle + instances.json
-> refcoco*_{split}_psalm.json.

Reference spec: datasets/build_RefCOCO.py — join the refs(<split>).p pickle
(ref_id, ann_id, sentences, split) with instances.json annotations (:6-40).
"""

import argparse
import json
import os
import pickle
from collections import defaultdict


def build(refs_pickle: str, instances_json: str, out_path: str,
          split: str = "val") -> None:
    with open(refs_pickle, "rb") as f:
        refs = pickle.load(f)
    with open(instances_json) as f:
        coco = json.load(f)
    anns = {a["id"]: a for a in coco["annotations"]}
    imgs = {im["id"]: im for im in coco["images"]}

    records = []
    new_img_id = 0
    for ref in refs:
        if ref.get("split") != split:
            continue
        ann = anns.get(ref["ann_id"])
        if ann is None:
            continue
        im = imgs[ann["image_id"]]
        records.append({
            "image": im["file_name"],
            "image_info": {"height": im["height"], "width": im["width"],
                           "file_name": im["file_name"]},
            "new_img_id": new_img_id,
            "anns": [ann],
            "instruction": [{"sent": s["sent"]} for s in ref["sentences"]],
            "ref_id": ref["ref_id"],
        })
        new_img_id += 1
    with open(out_path, "w") as f:
        json.dump(records, f)
    print(f"wrote {len(records)} records to {out_path}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--refs_pickle", required=True)
    p.add_argument("--instances_json", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    build(a.refs_pickle, a.instances_json, a.out, a.split)
