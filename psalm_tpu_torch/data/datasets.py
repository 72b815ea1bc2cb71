"""Batches for training: the task sampler, the collator and a synthetic
panoptic dataset.

``UnifiedTaskSampler`` and ``collate`` are the port's own copies of
``psalm_tpu/data/datasets.py``'s (held equal by
``tests/test_torch_copies.py``): host numpy, batches that hold one task
each. The COCO and RefCOCO dataset classes are not ported yet (their files
are on neither machine); ``SyntheticPanopticDataset`` stands in for
``PanopticDataset`` with the same sample keys, from a seed.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from psalm_tpu_torch.data.constants import CLS_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from psalm_tpu_torch.data.splicer import splice


class UnifiedTaskSampler:
    """Batch-homogeneous round-robin over task datasets
    (UnifyDatasetSingleDatasetForBatch, train_datasets.py:721-795): serve
    ``batch_size`` consecutive samples from one dataset, then advance.
    Dataset mixing ratios via list replication (train.py:347)."""

    def __init__(self, datasets: Sequence, batch_size: int, ratios=None,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1):
        """shard_index/num_shards: per-host sharding for multi-host training.
        Every host must construct the sampler with the SAME seed/ratios/
        batch_size — the task schedule (which dataset serves which batch) is
        then identical across hosts (the jitted step signature must agree
        globally), while the sample streams are disjoint: host h consumes
        positions h, h+num_shards, ... of the shared shuffle order."""
        assert 0 <= shard_index < num_shards
        self.datasets = []
        ratios = ratios or [1] * len(datasets)
        for ds, r in zip(datasets, ratios):
            self.datasets.extend([ds] * int(r))
        self.batch_size = batch_size
        self.rng = random.Random(seed)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.cursors = [shard_index] * len(self.datasets)
        self.orders = [self.rng.sample(range(len(ds)), len(ds))
                       for ds in self.datasets]
        self.cur_dataset = 0
        self.count_in_batch = 0

    def __iter__(self):
        return self

    def next_index(self) -> Tuple[int, int]:
        """Advance the schedule by one draw WITHOUT materializing the sample:
        returns (dataset_position, sample_index). The schedule is pure
        sampler state, so an async loader (data/prefetch.py) can run it
        ahead on the main thread — keeping determinism — and farm the heavy
        ds[idx] mapper work to workers."""
        ds_i = self.cur_dataset
        ds = self.datasets[ds_i]
        L = len(ds)
        # drop the len % num_shards tail so every shard exhausts the epoch
        # after exactly L_eff/num_shards draws — the reshuffle below is drawn
        # from the shared-seed rng at the same global step on every host
        L_eff = (L // self.num_shards) * self.num_shards
        if L_eff == 0:
            # dataset smaller than the host count: shards must overlap
            idx = self.orders[ds_i][self.cursors[ds_i] % L]
            self.cursors[ds_i] += self.num_shards
        else:
            if self.cursors[ds_i] >= L_eff:
                self.orders[ds_i] = self.rng.sample(range(L), L)
                self.cursors[ds_i] = self.shard_index
            idx = self.orders[ds_i][self.cursors[ds_i]]
            self.cursors[ds_i] += self.num_shards
        self.count_in_batch += 1
        if self.count_in_batch == self.batch_size:
            self.count_in_batch = 0
            self.cur_dataset = (self.cur_dataset + 1) % len(self.datasets)
        return ds_i, idx

    def __next__(self) -> Dict[str, Any]:
        ds_i, idx = self.next_index()
        return self.datasets[ds_i][idx]

    def next_batch(self) -> List[Dict[str, Any]]:
        return [next(self) for _ in range(self.batch_size)]

    def next_batch_indices(self) -> List[Tuple[int, int]]:
        return [self.next_index() for _ in range(self.batch_size)]


# the splicer's per-sample sequence arrays, all right-padded to pad_len
# (splicer.py SplicedSample) — the keys sequence bucketing may trim
_SEQ_KEYS = ("tok_ids", "src_type", "src_idx", "attention_mask", "labels",
             "seg_query_mask", "class_name_embedding_indices",
             "refer_embedding_indices", "region_embedding_mask")


def collate(samples: List[Dict[str, Any]],
            seq_bucket: int = 0) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into a batch (DataCollatorForCOCODatasetV2
    analog, train_datasets.py:968-1043 — but everything is already static).

    seq_bucket > 0: trim the uniform right-padding down to the batch's max
    real length rounded up to a multiple of seq_bucket (TPU-style length
    bucketing). The reference pads nothing at eval (torch runs each prompt
    at its natural length, model_max_length=2048 is only a cap); padding to
    a static 2048 makes Phi do ~2-3x the useful full-seq work on a ~800
    token panoptic prompt. Padding is inert end-to-end (masked keys,
    IGNORE labels, position-gathered heads), so outputs are identical for
    any bucket — tested in test_data_pipeline.py. Few distinct buckets
    arise in practice (prompts are near-constant per task), so jit
    recompiles stay bounded."""
    assert len({s["dataset_type"] for s in samples}) == 1, \
        "batch must be task-homogeneous"
    out: Dict[str, Any] = {}
    for k in samples[0]:
        if k == "dataset_type":
            out[k] = samples[0][k]
        elif k == "file_name":
            out[k] = [s["file_name"] for s in samples]
        elif k in ("image_id", "num_class_names"):
            out[k] = np.asarray([s[k] for s in samples])
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    if seq_bucket and "attention_mask" in out:
        lmax = int(out["attention_mask"].sum(-1).max())
        L = min(out["attention_mask"].shape[-1],
                -(-lmax // seq_bucket) * seq_bucket)
        for k in _SEQ_KEYS:
            if k in out:
                out[k] = np.ascontiguousarray(out[k][..., :L])
    return out


class SyntheticPanopticDataset:
    """``num_samples`` COCO-panoptic training samples made from ``seed``,
    with the keys of ``psalm_tpu/data/datasets.py::PanopticDataset`` (built
    with ``shuffle_classes``): the panoptic prompt's shape with
    ``num_classes`` class names of ``tokens_per_class`` random tokens, padded
    to the 128-multiple bucket; a raw uint8 image; ``num_masks`` target
    slots at the image size of which the first ``valid_masks`` hold random
    rectangles with random labels; and a ``random_idx`` permutation of the
    class names."""

    dataset_type = "panoptic_coco"

    def __init__(self, image_size: int, num_seg_queries: int,
                 num_classes: int, num_samples: int = 4, num_masks: int = 16,
                 valid_masks: int = 0, tokens_per_class: int = 3,
                 seed: int = 0):
        self.image_size = image_size
        self.num_seg_queries = num_seg_queries
        self.num_classes = num_classes
        self.num_samples = num_samples
        self.num_masks = num_masks
        self.valid_masks = valid_masks or num_masks
        self.tokens_per_class = tokens_per_class
        self.seed = seed

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed, idx))
        S, K, N = self.image_size, self.num_classes, self.num_masks
        n_img = (S // 64) ** 2
        ids = ([101, IMAGE_TOKEN_INDEX, 102] + [CLS_TOKEN_INDEX] * K
               + [103, SEG_TOKEN_INDEX, 104])
        cls_ids = rng.integers(5, 200, size=K * self.tokens_per_class)
        cls_idx = np.repeat(np.arange(K), self.tokens_per_class)
        n_real = len(ids) - 2 - K + n_img + self.num_seg_queries + len(cls_ids)
        s = splice(ids, [-100] * len(ids), num_image_tokens=n_img,
                   num_seg_queries=self.num_seg_queries,
                   pad_len=-(-n_real // 128) * 128, class_name_ids=cls_ids,
                   cls_indices=cls_idx)
        masks = np.zeros((N, S, S), np.uint8)
        for j in range(self.valid_masks):
            y0, x0 = rng.integers(0, S // 2, size=2)
            h, w = rng.integers(S // 8, S // 2, size=2)
            masks[j, y0:y0 + h, x0:x0 + w] = 1
        labels = np.zeros(N, np.int64)
        labels[:self.valid_masks] = rng.integers(0, K - 1, self.valid_masks)
        return {**s.as_dict(),
                "images": rng.integers(0, 256, (S, S, 3), dtype=np.uint8),
                "padding_mask": np.zeros((S, S), bool),
                "resized_hw": np.asarray((S, S)),
                "original_hw": np.asarray((S, S)),
                "gt_masks": masks, "gt_labels": labels,
                "gt_valid": np.arange(N) < self.valid_masks,
                "image_id": idx, "dataset_type": self.dataset_type,
                "num_class_names": K,
                "random_idx": rng.permutation(K).astype(np.int32)}
