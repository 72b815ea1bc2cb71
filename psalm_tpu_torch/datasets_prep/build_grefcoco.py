"""Offline converter: gRefCOCO -> grefcoco_{split}_psalm.json.

Reference spec: datasets/build_gRefCOCO.py — like RefCOCO but keeps
no-target refs (ann_id == [-1] / empty) with empty anns so N-acc style
metrics can score them."""

import argparse
import json
import pickle


def build(grefs_json: str, instances_json: str, out_path: str,
          split: str = "val") -> None:
    if grefs_json.endswith((".p", ".pkl")):
        with open(grefs_json, "rb") as f:
            refs = pickle.load(f)
    else:
        with open(grefs_json) as f:
            refs = json.load(f)
    with open(instances_json) as f:
        coco = json.load(f)
    anns = {a["id"]: a for a in coco["annotations"]}
    imgs = {im["id"]: im for im in coco["images"]}

    records = []
    new_img_id = 0
    for ref in refs:
        if ref.get("split") != split:
            continue
        ann_ids = ref.get("ann_id", [])
        if not isinstance(ann_ids, list):
            ann_ids = [ann_ids]
        ref_anns = [anns[a] for a in ann_ids if a in anns and a != -1]
        im = imgs[ref["image_id"]]
        records.append({
            "image": im["file_name"],
            "image_info": {"height": im["height"], "width": im["width"],
                           "file_name": im["file_name"]},
            "new_img_id": new_img_id,
            "anns": ref_anns,  # empty list == no-target sample
            "instruction": [{"sent": s["sent"]} for s in ref["sentences"]],
            "no_target": len(ref_anns) == 0,
        })
        new_img_id += 1
    with open(out_path, "w") as f:
        json.dump(records, f)
    n_nt = sum(r["no_target"] for r in records)
    print(f"wrote {len(records)} records ({n_nt} no-target) to {out_path}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--grefs", required=True)
    p.add_argument("--instances_json", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    build(a.grefs, a.instances_json, a.out, a.split)
