"""Eval runner for the COCO-panoptic task: the model forward, the reference's
crop-then-head geometry and the panoptic and semantic heads, per image.

Counterpart of ``psalm_tpu/eval/runner.py::EvalRunner`` for
``SegTask.PANOPTIC``. ``infer`` takes the same numpy batch dict (the
splicer's arrays, ``images``, ``padding_mask`` and optionally ``resized_hw``
and ``original_hw``) and returns the same results: ``panoptic_seg`` and
``sem_seg`` as per-image lists cropped to each original (H, W), and
``segments`` as [B, Q] arrays. The mask logits are restored to the original
pixel grid with interpolation matrices on a fixed "bucket" grid
(``psalm_tpu_torch/eval/geometry.py``) before the heads run, in f32.

The JAX runner's window-clamp telemetry and radius auto-raise are not
ported: the port's default sampler is exact and has no radius to raise.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from psalm_tpu_torch.config import PSALMConfig, SegTask
from psalm_tpu_torch.eval import geometry, postprocess

# arrays of the batch that the device never reads
_HOST_ONLY = {"dataset_type", "image_id", "num_class_names", "gt_masks",
              "gt_labels", "gt_valid", "file_name", "padding_mask",
              "resized_hw", "original_hw", "labels", "length"}


def bucket_for_sizes(sizes, multiple: int = 128) -> Tuple[int, int]:
    """Static (Hb, Wb) covering every (H, W) in ``sizes``, rounded up."""
    sizes = np.asarray(list(sizes), np.int64).reshape(-1, 2)
    up = lambda v: int(-(-int(v) // multiple) * multiple)
    return (up(sizes[:, 0].max()), up(sizes[:, 1].max()))


def synthetic_panoptic_batch(cfg: PSALMConfig, B: int, num_classes: int,
                             content_hw: Tuple[int, int],
                             original_hw: Tuple[int, int],
                             tokens_per_class: int = 3,
                             seed: int = 0) -> Dict[str, np.ndarray]:
    """A COCO-panoptic eval batch at the real sequence shape, with random
    images: ``num_classes`` class names of ``tokens_per_class`` tokens,
    spliced with the numpy splicer (``data/splicer.py``) and padded to the
    eval CLIs' 128-multiple bucket (``__graft_entry__._panoptic_batch``), and the
    non-square geometry of ``bench.py`` (content ``content_hw`` in the padded
    frame, original size ``original_hw``)."""
    from psalm_tpu_torch.data.constants import (CLS_TOKEN_INDEX,
                                                IMAGE_TOKEN_INDEX,
                                                SEG_TOKEN_INDEX)
    from psalm_tpu_torch.data.splicer import splice, stack_samples
    S = cfg.image_size
    n_img = (S // 64) ** 2
    nq = cfg.mask_decoder.num_queries
    ids = ([101, IMAGE_TOKEN_INDEX, 102] + [CLS_TOKEN_INDEX] * num_classes
           + [103, SEG_TOKEN_INDEX, 104])
    rng = np.random.default_rng(seed)
    cls_ids = rng.integers(5, 200, size=num_classes * tokens_per_class)
    cls_idx = np.repeat(np.arange(num_classes), tokens_per_class)
    n_real = n_img + nq + num_classes * tokens_per_class + 8
    pad_len = -(-n_real // 128) * 128
    batch = stack_samples([
        splice(ids, None, num_image_tokens=n_img, num_seg_queries=nq,
               pad_len=pad_len, class_name_ids=cls_ids, cls_indices=cls_idx)
        for _ in range(B)])
    batch["images"] = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    pad = np.ones((S, S), bool)
    pad[:content_hw[0], :content_hw[1]] = False
    batch["padding_mask"] = np.tile(pad, (B, 1, 1))
    batch["resized_hw"] = np.tile(np.asarray(content_hw), (B, 1))
    batch["original_hw"] = np.tile(np.asarray(original_hw), (B, 1))
    return batch


def _content_hw(batch: Dict[str, np.ndarray], S: int) -> np.ndarray:
    """[B, 2] (nh, nw): ``resized_hw``, else the extent of the un-padded
    region of ``padding_mask`` (the reference formula)."""
    if "resized_hw" in batch:
        return np.asarray(batch["resized_hw"]).reshape(-1, 2).astype(np.int64)
    v = ~np.asarray(batch["padding_mask"], bool)
    idx = np.arange(S)

    def ext(m):
        return (np.where(m, idx, -1).max(-1) - np.where(m, idx, S).min(-1) + 1)

    return np.maximum(np.stack([ext(v.any(2)), ext(v.any(1))], -1), 1)


class EvalRunner:
    def __init__(self, model, cfg: PSALMConfig, num_class_names=None,
                 is_thing=None, bucket_hw: Optional[Tuple[int, int]] = None):
        if SegTask(cfg.seg_task.value) is not SegTask.PANOPTIC:
            raise NotImplementedError(
                f"seg_task {cfg.seg_task.value!r}: only the panoptic eval "
                "path is ported")
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.num_class_names = num_class_names or cfg.num_classes + 1
        self.is_thing = (np.asarray(is_thing, bool) if is_thing is not None
                         else np.ones(self.num_class_names - 1, bool))
        self.bucket_hw = tuple(bucket_hw) if bucket_hw else (
            cfg.image_size, cfg.image_size)

    def _maybe_grow_bucket(self, batch) -> None:
        oh = np.asarray(batch["original_hw"]).reshape(-1, 2)
        if (oh[:, 0].max() <= self.bucket_hw[0]
                and oh[:, 1].max() <= self.bucket_hw[1]):
            return
        new = (max(self.bucket_hw[0], bucket_for_sizes(oh)[0]),
               max(self.bucket_hw[1], bucket_for_sizes(oh)[1]))
        print(f"eval bucket {self.bucket_hw} -> {new} to fit original size "
              f"{oh.max(0).tolist()}", file=sys.stderr)
        self.bucket_hw = new

    def stage(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The arrays the model reads, as tensors on the model's device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items() if k not in _HOST_ONLY}

    @torch.no_grad()
    def _infer_device(self, tbatch: Dict[str, torch.Tensor], content: np.ndarray,
                      original: np.ndarray) -> Dict[str, Any]:
        out = self.model(tbatch, num_class_names=self.num_class_names)
        masks = out["pred_masks"].float()  # [B, Q, S/4, S/4]
        logits = out["pred_class_name_logits"]
        B, Q = masks.shape[:2]
        S = self.cfg.image_size
        is_thing = torch.as_tensor(self.is_thing, device=self.device)
        pans, ids, cats, things, valids, sems = [], [], [], [], [], []
        for b in range(B):
            mo = geometry.crop_resize_to_original(masks[b], content[b],
                                                  original[b], S, self.bucket_hw)
            valid = geometry.valid_mask(original[b], self.bucket_hw, self.device)
            pan, info = postprocess.panoptic_inference(logits[b], mo, is_thing,
                                                       valid)
            pans.append(pan)
            ids.append(info["id"])
            cats.append(info["category"])
            things.append(info["isthing"])
            valids.append(info["valid"])
            sems.append(postprocess.semantic_inference(logits[b], mo).argmax(0))
        pan = torch.stack(pans)
        sem = torch.stack(sems)
        return {
            "panoptic_seg": pan.to(torch.uint8) if Q <= 255 else pan,
            "segments": {"id": torch.stack(ids), "category": torch.stack(cats),
                         "isthing": torch.stack(things),
                         "valid": torch.stack(valids)},
            "sem_seg": (sem.to(torch.uint8) if self.num_class_names <= 256
                        else sem.int()),
        }

    def infer(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        if "original_hw" in batch:
            self._maybe_grow_bucket(batch)
        content = _content_hw(batch, self.cfg.image_size)
        if "original_hw" in batch:
            original = np.asarray(batch["original_hw"]).reshape(-1, 2)
        else:  # the reference's .get fallback: the content extent
            original = content
        out = self._infer_device(self.stage(batch), content, original)
        out = {"panoptic_seg": out["panoptic_seg"].cpu().numpy(),
               "segments": {k: v.cpu().numpy()
                            for k, v in out["segments"].items()},
               "sem_seg": out["sem_seg"].cpu().numpy()}
        return self._crop_to_original(out, original)

    @staticmethod
    def _crop_to_original(out: Dict[str, Any], original_hw: np.ndarray
                          ) -> Dict[str, Any]:
        """Slice bucket-resolution maps to each image's true (H, W); per-image
        shapes differ, so the maps become lists indexed by b."""
        oh = np.asarray(original_hw).reshape(-1, 2)
        for key in ("panoptic_seg", "sem_seg"):
            x = out[key]
            out[key] = [x[b, :oh[b, 0], :oh[b, 1]] for b in range(len(x))]
        return out
