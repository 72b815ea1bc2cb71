"""The one general generator of the benchmark's traffic: batches of the
port's numpy batch format, made on the host from ``--seed`` and a mix's
parameters (``traffic/<mix>.json``).

Copies, rewritten here, of the port's sound generators: ``eval/runner.py::
_spliced_batch`` / ``synthetic_panoptic_batch`` / ``synthetic_referring_
batch`` (eval) and ``data/datasets.py::SyntheticPanopticDataset`` with
``collate`` (training). Every seed gives the same sizes (sequence length,
geometry, counts of masks); the seed draws only the values: tokens, pixels,
rectangles and labels.

Mix parameters (all kinds): ``batch`` (rows a call on one card),
``pool_batches`` (distinct batches, cycled by the timed loop); eval:
``task`` (panoptic or referring), ``class_names`` and ``tokens_per_class``
or ``refer_tokens``, ``content_hw``, ``original_hw``; training:
``class_names``, ``tokens_per_class``, ``mask_slots``, ``valid_masks``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from h100_bench.gen.splicer import splice, stack_samples
from h100_bench.reference.constants import (CLS_TOKEN_INDEX, IGNORE_INDEX,
                                            IMAGE_TOKEN_INDEX,
                                            REFER_TOKEN_INDEX, SEG_TOKEN_INDEX)

# the rows of a seed: independent streams per (seed, kind, index)
_KIND = {"eval": 1, "train": 2, "draws": 3}


def rng(seed: int, kind: str, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), _KIND[kind], *index])


def padded_length(n_real: int, multiple: int = 128) -> int:
    return -(-n_real // multiple) * multiple


def eval_prompt(task: str, mix: Dict[str, Any], r: np.random.Generator):
    """(ids, splice keywords, extra tokens) of one eval prompt: the panoptic
    prompt with ``class_names`` names of ``tokens_per_class`` tokens, or
    the referring prompt with a sentence of ``refer_tokens`` tokens."""
    if task == "panoptic":
        K, per = mix["class_names"], mix["tokens_per_class"]
        ids = ([101, IMAGE_TOKEN_INDEX, 102] + [CLS_TOKEN_INDEX] * K
               + [103, SEG_TOKEN_INDEX, 104])
        cls_ids = r.integers(5, 200, size=K * per)
        kw = dict(class_name_ids=cls_ids,
                  cls_indices=np.repeat(np.arange(K), per))
        return ids, kw, len(cls_ids)
    if task == "referring":
        ids = [101, IMAGE_TOKEN_INDEX, 102, REFER_TOKEN_INDEX, 103,
               SEG_TOKEN_INDEX, 104]
        refer = r.integers(5, 200, size=mix["refer_tokens"])
        return ids, dict(token_refer_id=refer), len(refer)
    raise ValueError(f"eval task {task!r}")


def eval_batch(mix: Dict[str, Any], image_size: int, num_queries: int,
               seed: int, index: int) -> Dict[str, np.ndarray]:
    """Batch ``index`` of an eval pool: ``batch`` rows, each a prompt
    spliced and padded to the 128-multiple bucket, a random image (N(0, 1),
    already normalized) in the padded frame with the non-square content and
    original sizes. The panoptic prompt is the same for every image of a
    seed (an evaluation asks every image for the same classes); a referring
    sentence is drawn per image."""
    S, B, task = image_size, mix["batch"], mix["task"]
    n_img = (S // 64) ** 2
    expanded = (IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX, CLS_TOKEN_INDEX,
                REFER_TOKEN_INDEX)
    shared = eval_prompt(task, mix, rng(seed, "eval", 0))
    rows = []
    for b in range(B):
        r = rng(seed, "eval", 1, index, b)
        ids, kw, extra = (shared if task == "panoptic"
                          else eval_prompt(task, mix, r))
        n_real = sum(t not in expanded for t in ids) + n_img + num_queries \
            + extra
        rows.append(splice(ids, None, num_image_tokens=n_img,
                           num_seg_queries=num_queries,
                           pad_len=padded_length(n_real), **kw))
    batch = stack_samples(rows)
    r = rng(seed, "eval", 2, index)
    batch["images"] = r.standard_normal((B, S, S, 3), dtype=np.float32)
    content = tuple(mix["content_hw"])
    pad = np.ones((S, S), bool)
    pad[:content[0], :content[1]] = False
    batch["padding_mask"] = np.tile(pad, (B, 1, 1))
    batch["resized_hw"] = np.tile(np.asarray(content), (B, 1))
    batch["original_hw"] = np.tile(np.asarray(mix["original_hw"]), (B, 1))
    return batch


def train_sample(mix: Dict[str, Any], image_size: int, num_queries: int,
                 seed: int, idx: int) -> Dict[str, Any]:
    """Training sample ``idx`` of a seed: the panoptic prompt with
    ``class_names`` names of ``tokens_per_class`` random tokens, a raw
    uint8 image, ``mask_slots`` target slots at the image size of which the
    first ``valid_masks`` hold random rectangles with random labels, and a
    ``random_idx`` permutation of the class names (the keys of the port's
    ``SyntheticPanopticDataset``)."""
    r = rng(seed, "train", idx)
    S, K, N = image_size, mix["class_names"], mix["mask_slots"]
    valid_n, per = mix["valid_masks"], mix["tokens_per_class"]
    n_img = (S // 64) ** 2
    ids = ([101, IMAGE_TOKEN_INDEX, 102] + [CLS_TOKEN_INDEX] * K
           + [103, SEG_TOKEN_INDEX, 104])
    cls_ids = r.integers(5, 200, size=K * per)
    n_real = len(ids) - 2 - K + n_img + num_queries + len(cls_ids)
    s = splice(ids, [IGNORE_INDEX] * len(ids), num_image_tokens=n_img,
               num_seg_queries=num_queries, pad_len=padded_length(n_real),
               class_name_ids=cls_ids,
               cls_indices=np.repeat(np.arange(K), per))
    masks = np.zeros((N, S, S), np.uint8)
    for j in range(valid_n):
        y0, x0 = r.integers(0, S // 2, size=2)
        h, w = r.integers(S // 8, S // 2, size=2)
        masks[j, y0:y0 + h, x0:x0 + w] = 1
    labels = np.zeros(N, np.int64)
    labels[:valid_n] = r.integers(0, K - 1, valid_n)
    return {**s.as_dict(),
            "images": r.integers(0, 256, (S, S, 3), dtype=np.uint8),
            "padding_mask": np.zeros((S, S), bool),
            "resized_hw": np.asarray((S, S)),
            "original_hw": np.asarray((S, S)),
            "gt_masks": masks, "gt_labels": labels,
            "gt_valid": np.arange(N) < valid_n,
            "image_id": idx, "dataset_type": "panoptic_coco",
            "num_class_names": K,
            "random_idx": r.permutation(K).astype(np.int32)}


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-sample dicts stacked into a batch (the port's ``collate`` without
    its sequence bucketing, which the mixes here do not use)."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        if k == "dataset_type":
            out[k] = samples[0][k]
        elif k in ("image_id", "num_class_names"):
            out[k] = np.asarray([s[k] for s in samples])
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


def train_batch(mix: Dict[str, Any], image_size: int, num_queries: int,
                seed: int, index: int, rank: int = 0,
                ranks: int = 1) -> Dict[str, Any]:
    """Data rank ``rank``'s rows of global batch ``index``: ``batch``
    samples a rank, ``batch * ranks`` a step, every sample distinct."""
    B = mix["batch"]
    first = (index * ranks + rank) * B
    return collate([train_sample(mix, image_size, num_queries, seed, i)
                    for i in range(first, first + B)])


class Draws:
    """The criterion's uniform draws, made by the benchmark from the seed
    and handed to the program and to the reference alike (the port's
    ``uniform_fn(generator, shape)`` hook): a ``torch.Generator`` on the
    device, seeded from the seed, whose stream both sides consume in the
    same order. The program's generator argument is not used."""

    def __init__(self, seed: int, device):
        import torch
        self.gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 7919 + 17) % (2 ** 63))
        self.device = device

    def __call__(self, generator, shape):
        import torch
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device, dtype=torch.float32)
