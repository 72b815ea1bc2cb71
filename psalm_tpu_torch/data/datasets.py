"""Task datasets, the task sampler, the collator and a synthetic panoptic
dataset.

Counterpart of ``psalm_tpu/data/datasets.py`` (held equal by
``tests/test_torch_copies.py`` and ``tests/test_torch_data.py``). Behavioral
spec: psalm/train/train_datasets.py — one dataset per task family
(``PanopticDataset``, ``InstanceDataset``, ``InteractiveDataset``,
``ReferringDataset``, ``SemanticDataset``, ``MMConvDataset``), each building
the exact prompt strings (§2.3 of SURVEY.md), tokenizing with sentinel
splicing and attaching targets; every sample is expanded by
``data/splicer.py`` into aligned static arrays, and targets are padded to a
static N_max with validity masks. ``UnifiedTaskSampler`` serves batches that
hold one task each (the reference's UnifyDatasetSingleDatasetForBatch,
train_datasets.py:721-795), and ``collate`` stacks them.
``SyntheticPanopticDataset`` makes ``PanopticDataset``-keyed training
samples from a seed.

COCO class tables are public COCO metadata (same 80-class list the reference
embeds at train_datasets.py:371-396).
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from psalm_tpu_torch.data import coco_rle
from psalm_tpu_torch.data.constants import (CLS_TOKEN_INDEX,
                                            IMAGE_TOKEN_INDEX,
                                            SEG_TOKEN_INDEX)
from psalm_tpu_torch.data.conversation import conv_llava_phi
from psalm_tpu_torch.data.mappers import ImageMapper
from psalm_tpu_torch.data.splicer import SplicedSample, splice
from psalm_tpu_torch.data.tokenization import (build_conversation,
                                               interactive_prompt,
                                               panoptic_prompt,
                                               referring_prompt,
                                               tokenize_class_names,
                                               tokenize_conversation,
                                               tokenize_referring_sentence)

COCO_CLASS_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43,
    44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62,
    63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85,
    86, 87, 88, 89, 90]
COCO_CLASS_NAMES = [
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella', 'handbag',
    'tie', 'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite',
    'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon',
    'bowl', 'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
    'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant',
    'bed', 'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush']


class DataConfig:
    """Static-shape knobs for the pipeline."""

    def __init__(self, image_size=1024, num_image_tokens=256, num_seg_queries=100,
                 pad_len=2048, max_gt_masks=100, max_regions=20,
                 num_region_points=256, seed=0, device_normalize=True):
        self.image_size = image_size
        # ship uint8 canvases; the model normalizes on device (4x less
        # host->device traffic; identical math — see data/mappers.py)
        self.device_normalize = device_normalize
        self.num_image_tokens = num_image_tokens
        self.num_seg_queries = num_seg_queries
        self.pad_len = pad_len
        self.max_gt_masks = max_gt_masks
        self.max_regions = max_regions
        self.num_region_points = num_region_points
        self.seed = seed


class BaseTaskDataset:
    dataset_type = "base"

    def __init__(self, tokenizer, cfg: DataConfig, class_names=None,
                 is_train=True):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.mapper = ImageMapper(cfg.image_size,
                                  cfg.device_normalize)
        self.is_train = is_train
        self.coco_class_name = list(class_names) if class_names else \
            COCO_CLASS_NAMES + ["background"]
        self.rng = np.random.default_rng(cfg.seed)

    def __len__(self):
        return len(self.data)

    # -- shared helpers -----------------------------------------------------

    def _load_image(self, path: str) -> np.ndarray:
        return np.asarray(Image.open(path).convert("RGB"))

    def _splice(self, input_ids, labels, **kw) -> SplicedSample:
        return splice(input_ids, labels if self.is_train else None,
                      num_image_tokens=self.cfg.num_image_tokens,
                      num_seg_queries=self.cfg.num_seg_queries,
                      pad_len=self.cfg.pad_len, **kw)

    def _pad_targets(self, gt: Dict) -> Dict:
        N = self.cfg.max_gt_masks
        S = self.cfg.image_size
        n = min(len(gt["gt_classes"]), N)
        masks = np.zeros((N, S, S), np.uint8)
        labels = np.zeros((N,), np.int64)
        valid = np.zeros((N,), bool)
        masks[:n] = gt["gt_masks"][:n]
        labels[:n] = gt["gt_classes"][:n]
        valid[:n] = True
        return {"gt_masks": masks, "gt_labels": labels, "gt_valid": valid}


class PanopticDataset(BaseTaskDataset):
    """COCO_panoptic_dataset (train_datasets.py:43-234); the ``shuffle``
    variant reproduces COCO_panoptic_dataset_random (:489-563) emitting a
    random_idx permutation."""

    dataset_type = "panoptic_coco"

    def __init__(self, root, tokenizer, cfg, is_train=True, shuffle_classes=False):
        split = "train2017" if is_train else "val2017"
        self.root = root
        self.image_path = os.path.join(root, split)
        self.pan_gt_path = os.path.join(root, f"panoptic_{split}")
        ann_path = os.path.join(root, f"annotations/panoptic_{split}.json")
        with open(ann_path) as f:
            meta = json.load(f)
        self.data = meta["annotations"]
        # original sizes (when the json carries an images table) let eval
        # CLIs pick a tight original-resolution bucket for the heads
        self.image_sizes = [(im["height"], im["width"])
                            for im in meta.get("images", [])] or None
        cats = meta["categories"]
        self.coco_id_to_cont_id = {c["id"]: i for i, c in enumerate(cats)}
        self.is_thing = [bool(c["isthing"]) for c in cats]
        super().__init__(tokenizer, cfg,
                         class_names=[c["name"] for c in cats] + ["background"],
                         is_train=is_train)
        self.shuffle_classes = shuffle_classes

    def __getitem__(self, idx) -> Dict[str, Any]:
        rec = self.data[idx]
        image = self._load_image(os.path.join(
            self.image_path, os.path.splitext(rec["file_name"])[0] + ".jpg"))
        proc = self.mapper.transform_image(image)
        pan_rgb = np.asarray(Image.open(
            os.path.join(self.pan_gt_path, rec["file_name"])).convert("RGB"))
        segments = [dict(s, category_id=self.coco_id_to_cont_id[s["category_id"]])
                    for s in rec["segments_info"]]
        gt = self.mapper.panoptic_targets(pan_rgb, segments)

        names = self.coco_class_name
        K = len(names)
        random_idx = None
        if self.shuffle_classes:
            perm = list(range(K))
            random.shuffle(perm)
            names = [self.coco_class_name[i] for i in perm]
            random_idx = np.argsort(perm)
        human, gpt = panoptic_prompt(K)
        prompt = build_conversation(human, gpt)
        input_ids, labels = tokenize_conversation(prompt, self.tokenizer)
        cls_ids, cls_idx = tokenize_class_names(names, self.tokenizer)
        s = self._splice(input_ids, labels, class_name_ids=cls_ids,
                         cls_indices=cls_idx)

        out = {**s.as_dict(), "images": proc.image,
               "padding_mask": proc.padding_mask,
               "resized_hw": np.asarray(proc.resized_hw),
               "original_hw": np.asarray(proc.original_hw),
               **self._pad_targets({"gt_classes": gt["gt_classes"],
                                    "gt_masks": gt["gt_masks"]}),
               "image_id": rec.get("image_id", idx),
               "file_name": rec["file_name"],
               "dataset_type": self.dataset_type,
               "num_class_names": K}
        if random_idx is not None:
            out["random_idx"] = random_idx.astype(np.int32)
        return out


class InstanceDataset(BaseTaskDataset):
    """COCO_instance_dataset (train_datasets.py:356-487): panoptic-style
    prompt over the 80 thing classes + background."""

    dataset_type = "instance_coco"

    def __init__(self, json_path, image_folder, tokenizer, cfg, is_train=True):
        with open(json_path) as f:
            self.data = json.load(f)
        self.image_folder = image_folder
        self.coco_id_to_cont_id = {cid: i for i, cid in enumerate(COCO_CLASS_IDS)}
        # original sizes -> tight eval bucket for the original-grid heads
        self.image_sizes = [
            (r["image_info"]["height"], r["image_info"]["width"])
            for r in self.data if "image_info" in r] or None
        super().__init__(tokenizer, cfg, is_train=is_train)

    def _record_targets(self, rec):
        anns = []
        for a in rec["anns"]:
            cid = a["category_id"]
            if cid in self.coco_id_to_cont_id:
                cid = self.coco_id_to_cont_id[cid]
            anns.append(dict(a, category_id=cid))
        hw = (rec["image_info"]["height"], rec["image_info"]["width"])
        return self.mapper.instance_targets(anns, hw), anns, hw

    def __getitem__(self, idx):
        rec = self.data[idx]
        image = self._load_image(os.path.join(self.image_folder, rec["image"]))
        proc = self.mapper.transform_image(image)
        gt, _, _ = self._record_targets(rec)

        K = len(self.coco_class_name)
        human, gpt = panoptic_prompt(K)
        prompt = build_conversation(human, gpt)
        input_ids, labels = tokenize_conversation(prompt, self.tokenizer)
        cls_ids, cls_idx = tokenize_class_names(self.coco_class_name,
                                                self.tokenizer)
        s = self._splice(input_ids, labels, class_name_ids=cls_ids,
                         cls_indices=cls_idx)
        return {**s.as_dict(), "images": proc.image,
                "padding_mask": proc.padding_mask,
                "resized_hw": np.asarray(proc.resized_hw),
                "original_hw": np.asarray(proc.original_hw),
                **self._pad_targets({"gt_classes": gt["gt_classes"],
                                     "gt_masks": gt["gt_masks"]}),
                "image_id": rec["new_img_id"],
                "file_name": rec["image"],
                "dataset_type": self.dataset_type,
                "num_class_names": K}


class InteractiveDataset(InstanceDataset):
    """COCO_interactive_dataset (train_datasets.py:236-354): visual-prompt
    regions ride the LLM; targets are the prompted instances in order."""

    dataset_type = "region_coco"

    def __init__(self, json_path, image_folder, tokenizer, cfg, is_train=True,
                 region_mask_type="point_visual_prompt_mask"):
        super().__init__(json_path, image_folder, tokenizer, cfg, is_train)
        self.region_mask_type = region_mask_type

    def __getitem__(self, idx):
        rec = self.data[idx]
        image = self._load_image(os.path.join(self.image_folder, rec["image"]))
        proc = self.mapper.transform_image(image)
        gt, anns, hw = self._record_targets(rec)

        vp_masks = self.mapper.visual_prompts(anns, self.region_mask_type)
        vp_masks = [self.mapper.transform_mask(m) for m in vp_masks]
        R = min(len(vp_masks), self.cfg.max_regions)
        pts = np.zeros((self.cfg.max_regions, self.cfg.num_region_points, 2),
                       np.float32)
        region_valid = np.zeros((self.cfg.max_regions,), bool)
        for i in range(R):
            pts[i] = ImageMapper.sample_region_points(
                vp_masks[i], self.cfg.num_region_points, self.rng)
            region_valid[i] = True

        human, gpt = interactive_prompt(max(R, 1))
        prompt = build_conversation(human, gpt)
        input_ids, labels = tokenize_conversation(prompt, self.tokenizer)
        s = self._splice(input_ids, labels, num_regions=max(R, 1))
        return {**s.as_dict(), "images": proc.image,
                "padding_mask": proc.padding_mask,
                "resized_hw": np.asarray(proc.resized_hw),
                "original_hw": np.asarray(proc.original_hw),
                "region_points": pts, "region_valid": region_valid,
                **self._pad_targets({"gt_classes": gt["gt_classes"][:R],
                                     "gt_masks": gt["gt_masks"][:R]}),
                "image_id": rec["new_img_id"],
                "file_name": rec["image"],
                "dataset_type": self.dataset_type}


class ReferringDataset(InstanceDataset):
    """RefCOCO_dataset (train_datasets.py:617-698)."""

    dataset_type = "referring_coco"

    def __init__(self, json_path, image_folder, tokenizer, cfg, is_train=True):
        super().__init__(json_path, image_folder, tokenizer, cfg, is_train)

    def original_gt_mask(self, idx):
        """Union gt mask decoded at the ORIGINAL (H, W) — the reference's
        referring/gRefCOCO evals decode annotation RLEs/polygons at original
        resolution (referring_segmentation.py:252-271), never the padded
        frame. Host-side only (no static-shape constraint)."""
        rec = self.data[idx]
        H = rec["image_info"]["height"]
        W = rec["image_info"]["width"]
        gt = np.zeros((H, W), bool)
        for a in rec["anns"]:
            seg = a.get("segmentation")
            if seg is None:
                continue
            if isinstance(seg, dict):
                m = coco_rle.decode(seg)
            else:
                m = coco_rle.merge_polygons_to_mask(seg, H, W)
            gt |= m.astype(bool)
        return gt

    def __getitem__(self, idx):
        rec = self.data[idx]
        image = self._load_image(os.path.join(
            self.image_folder, rec["image_info"]["file_name"]))
        proc = self.mapper.transform_image(image)
        gt, _, _ = self._record_targets(rec)

        instruction = "".join(" {}.".format(s["sent"])
                              for s in rec["instruction"])
        human, gpt = referring_prompt()
        prompt = build_conversation(human, gpt)
        input_ids, labels = tokenize_conversation(prompt, self.tokenizer)
        refer_ids = tokenize_referring_sentence(instruction, self.tokenizer)
        s = self._splice(input_ids, labels, token_refer_id=refer_ids)
        return {**s.as_dict(), "images": proc.image,
                "padding_mask": proc.padding_mask,
                "resized_hw": np.asarray(proc.resized_hw),
                "original_hw": np.asarray(proc.original_hw),
                **self._pad_targets({"gt_classes": gt["gt_classes"],
                                     "gt_masks": gt["gt_masks"]}),
                "image_id": rec["new_img_id"],
                "file_name": rec["image_info"]["file_name"],
                "dataset_type": self.dataset_type}


class SemanticDataset(BaseTaskDataset):
    """COCO_semantic_dataset (train_datasets.py:565-615): semantic label PNG
    -> one binary gt mask per present class, panoptic-style prompt over the
    full class list."""

    dataset_type = "semantic_coco"

    def __init__(self, list_json, image_folder, label_folder, tokenizer, cfg,
                 is_train=True, ignore_label=255, class_names=None):
        with open(list_json) as f:
            self.data = json.load(f)
        self.image_folder = image_folder
        self.label_folder = label_folder
        self.ignore_label = ignore_label
        super().__init__(tokenizer, cfg, class_names=class_names,
                         is_train=is_train)

    def __getitem__(self, idx):
        rec = self.data[idx]
        image = self._load_image(os.path.join(self.image_folder, rec["image"]))
        proc = self.mapper.transform_image(image)
        label = np.asarray(Image.open(os.path.join(self.label_folder,
                                                   rec["label"])))
        label_t = self.mapper.transform_mask(label.astype(np.uint8))
        classes = np.unique(label_t)
        classes = classes[(classes != self.ignore_label)
                          & (classes < len(self.coco_class_name) - 1)]
        masks = np.stack([(label_t == c) for c in classes]).astype(np.float32) \
            if len(classes) else np.zeros((0, *label_t.shape), np.float32)

        K = len(self.coco_class_name)
        human, gpt = panoptic_prompt(K, task_name="Semantic Segmentation")
        prompt = build_conversation(human, gpt)
        input_ids, labels = tokenize_conversation(prompt, self.tokenizer)
        cls_ids, cls_idx = tokenize_class_names(self.coco_class_name,
                                                self.tokenizer)
        s = self._splice(input_ids, labels, class_name_ids=cls_ids,
                         cls_indices=cls_idx)
        return {**s.as_dict(), "images": proc.image,
                "padding_mask": proc.padding_mask,
                "resized_hw": np.asarray(proc.resized_hw),
                "original_hw": np.asarray(proc.original_hw),
                **self._pad_targets({"gt_classes": classes.astype(np.int64),
                                     "gt_masks": masks}),
                "image_id": rec.get("image_id", idx),
                "dataset_type": self.dataset_type,
                "num_class_names": K}


class MMConvDataset(BaseTaskDataset):
    """MM_Conv_Dataset (train_datasets.py:797-966): LLaVA-1.5 chat data; LLM
    CE loss only, no mask targets."""

    dataset_type = "mm_conv"

    def __init__(self, json_path, image_folder, tokenizer, cfg, is_train=True):
        with open(json_path) as f:
            self.data = json.load(f)
        self.image_folder = image_folder
        super().__init__(tokenizer, cfg, is_train=is_train)

    def __getitem__(self, idx):
        rec = self.data[idx]
        image = self._load_image(os.path.join(self.image_folder, rec["image"]))
        proc = self.mapper.transform_image(image)
        convs = rec["conversations"]
        conv = conv_llava_phi.copy()
        role_map = {"human": conv.roles[0], "gpt": conv.roles[1]}
        for m in convs:
            conv.append_message(role_map[m["from"]], m["value"])
        prompt = conv.get_prompt()
        input_ids, labels = tokenize_conversation(prompt, self.tokenizer)
        s = self._splice(input_ids, labels)
        return {**s.as_dict(), "images": proc.image,
                "padding_mask": proc.padding_mask,
                "resized_hw": np.asarray(proc.resized_hw),
                "original_hw": np.asarray(proc.original_hw),
                "image_id": rec.get("id", idx),
                "dataset_type": self.dataset_type}


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
