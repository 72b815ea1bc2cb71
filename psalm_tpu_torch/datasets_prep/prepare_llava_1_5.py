"""Offline converter: filter LLaVA-1.5 mix665k to multimodal-only samples.

Reference spec: datasets/prepare_llava_1_5.py — drop text-only records
(docs/DATASET.md:87)."""

import argparse
import json


def build(mix_json: str, out_path: str) -> None:
    with open(mix_json) as f:
        data = json.load(f)
    kept = [rec for rec in data if "image" in rec]
    with open(out_path, "w") as f:
        json.dump(kept, f)
    print(f"kept {len(kept)}/{len(data)} multimodal records -> {out_path}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--mix_json", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    build(a.mix_json, a.out)
