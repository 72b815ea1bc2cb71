"""Eval runner: the model forward, the reference's crop-then-head geometry
and the task's inference head, per image.

Counterpart of ``psalm_tpu/eval/runner.py::EvalRunner`` for the tasks
``PANOPTIC``, ``SEMANTIC``, ``INSTANCE``, ``REFERRING`` and ``REGION``
(``cfg.seg_task``), with the JAX runner's conditioning flags per task.
``infer`` takes the same numpy batch dict (the splicer's arrays, ``images``,
``padding_mask``, optionally ``resized_hw`` and ``original_hw``, and for the
region task ``region_points`` and ``region_valid``) and returns the same
results, maps cropped to each original (H, W) as per-image lists:
  * PANOPTIC: ``panoptic_seg``, ``segments`` ([B, Q] arrays), ``sem_seg``;
  * SEMANTIC: ``sem_seg``, from the head at the padded frame, restored after
    (the reference's ``sem_seg_postprocess_before_inference=False``);
  * INSTANCE / REFERRING / REGION: ``instances`` / ``referring`` /
    ``region``, dicts whose ``masks`` are per-image [k, H, W] lists.
Except for SEMANTIC, the mask logits are restored to the original pixel grid
with interpolation matrices on a fixed "bucket" grid
(``psalm_tpu_torch/eval/geometry.py``) before the heads run, in f32.

The eval CLIs call ``stage(batch)`` on a ``Prefetcher`` thread and
``infer(batch, staged=...)`` on theirs, so that the dataset read, the
collate and the upload of batch i+1 overlap batch i's inference and
metrics, and
restore the ground truth with ``restore_map`` / ``restore_masks`` (OpenCV,
as JAX's runner).

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
from psalm_tpu_torch.ops.sampling import resize_bilinear

# arrays of the batch that the device never reads
_HOST_ONLY = {"dataset_type", "image_id", "num_class_names", "gt_masks",
              "gt_labels", "gt_valid", "file_name", "padding_mask",
              "resized_hw", "original_hw", "labels", "length"}


def bucket_for_sizes(sizes, multiple: int = 128) -> Tuple[int, int]:
    """Static (Hb, Wb) covering every (H, W) in ``sizes``, rounded up."""
    sizes = np.asarray(list(sizes), np.int64).reshape(-1, 2)
    up = lambda v: int(-(-int(v) // multiple) * multiple)
    return (up(sizes[:, 0].max()), up(sizes[:, 1].max()))


def _spliced_batch(cfg: PSALMConfig, ids, B: int,
                   content_hw: Tuple[int, int], original_hw: Tuple[int, int],
                   rng: np.random.Generator, extra_tokens: int = 0,
                   **splice_kw) -> Dict[str, np.ndarray]:
    """B copies of the prompt ``ids`` spliced with the numpy splicer
    (``data/splicer.py``) and padded to the eval CLIs' 128-multiple bucket
    (``__graft_entry__._panoptic_batch``), with random images and the
    non-square geometry of ``bench.py`` (content ``content_hw`` in the
    padded frame, original size ``original_hw``). ``extra_tokens`` counts
    the class-name and sentence tokens of <cls> and <refer>."""
    from psalm_tpu_torch.data.constants import (CLS_TOKEN_INDEX,
                                                IMAGE_TOKEN_INDEX,
                                                REFER_TOKEN_INDEX,
                                                SEG_TOKEN_INDEX)
    from psalm_tpu_torch.data.splicer import splice, stack_samples
    S = cfg.image_size
    n_img = (S // 64) ** 2
    nq = cfg.mask_decoder.num_queries
    expanded = (IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX, CLS_TOKEN_INDEX,
                REFER_TOKEN_INDEX)
    n_real = (sum(t not in expanded for t in ids) + n_img + nq
              + extra_tokens)
    pad_len = -(-n_real // 128) * 128
    batch = stack_samples([
        splice(ids, None, num_image_tokens=n_img, num_seg_queries=nq,
               pad_len=pad_len, **splice_kw) for _ in range(B)])
    batch["images"] = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    pad = np.ones((S, S), bool)
    pad[:content_hw[0], :content_hw[1]] = False
    batch["padding_mask"] = np.tile(pad, (B, 1, 1))
    batch["resized_hw"] = np.tile(np.asarray(content_hw), (B, 1))
    batch["original_hw"] = np.tile(np.asarray(original_hw), (B, 1))
    return batch


def synthetic_panoptic_batch(cfg: PSALMConfig, B: int, num_classes: int,
                             content_hw: Tuple[int, int],
                             original_hw: Tuple[int, int],
                             tokens_per_class: int = 3,
                             seed: int = 0) -> Dict[str, np.ndarray]:
    """A COCO-panoptic eval batch at the real sequence shape: ``num_classes``
    class names of ``tokens_per_class`` random tokens (``_spliced_batch``).
    The semantic and instance tasks take the same batch."""
    from psalm_tpu_torch.data.constants import (CLS_TOKEN_INDEX,
                                                IMAGE_TOKEN_INDEX,
                                                SEG_TOKEN_INDEX)
    ids = ([101, IMAGE_TOKEN_INDEX, 102] + [CLS_TOKEN_INDEX] * num_classes
           + [103, SEG_TOKEN_INDEX, 104])
    rng = np.random.default_rng(seed)
    cls_ids = rng.integers(5, 200, size=num_classes * tokens_per_class)
    cls_idx = np.repeat(np.arange(num_classes), tokens_per_class)
    return _spliced_batch(cfg, ids, B, content_hw, original_hw, rng,
                          extra_tokens=len(cls_ids), class_name_ids=cls_ids,
                          cls_indices=cls_idx)


def synthetic_referring_batch(cfg: PSALMConfig, B: int,
                              content_hw: Tuple[int, int],
                              original_hw: Tuple[int, int],
                              refer_tokens: int = 12,
                              seed: int = 0) -> Dict[str, np.ndarray]:
    """A referring eval batch: the referring prompt's shape, a sentence of
    ``refer_tokens`` random tokens at <refer> (``token_refer_id``)."""
    from psalm_tpu_torch.data.constants import (IMAGE_TOKEN_INDEX,
                                                REFER_TOKEN_INDEX,
                                                SEG_TOKEN_INDEX)
    ids = [101, IMAGE_TOKEN_INDEX, 102, REFER_TOKEN_INDEX, 103,
           SEG_TOKEN_INDEX, 104]
    rng = np.random.default_rng(seed)
    refer = rng.integers(5, 200, size=refer_tokens)
    return _spliced_batch(cfg, ids, B, content_hw, original_hw, rng,
                          extra_tokens=refer_tokens, token_refer_id=refer)


def synthetic_region_batch(cfg: PSALMConfig, B: int,
                           content_hw: Tuple[int, int],
                           original_hw: Tuple[int, int], regions: int = 4,
                           valid_regions: Optional[int] = None,
                           points: int = 256,
                           seed: int = 0) -> Dict[str, np.ndarray]:
    """A region eval batch: ``regions`` slots of ``points`` points each,
    sampled by ``ImageMapper.sample_region_points`` from random rectangles
    inside the content, of which the first ``valid_regions`` (all by
    default) are real prompts with a <region> token each, as the region
    dataset pads its prompts to a fixed count."""
    from psalm_tpu_torch.data.constants import (IMAGE_TOKEN_INDEX,
                                                REGION_TOKEN_INDEX,
                                                SEG_TOKEN_INDEX)
    from psalm_tpu_torch.data.mappers import ImageMapper
    n_valid = regions if valid_regions is None else valid_regions
    ids = ([101, IMAGE_TOKEN_INDEX, 102] + [REGION_TOKEN_INDEX, 105] * n_valid
           + [103, SEG_TOKEN_INDEX, 104])
    rng = np.random.default_rng(seed)
    batch = _spliced_batch(cfg, ids, B, content_hw, original_hw, rng,
                           num_regions=n_valid)
    S = cfg.image_size
    pts = np.zeros((B, regions, points, 2), np.float32)
    valid = np.zeros((B, regions), bool)
    for b in range(B):
        for r in range(n_valid):
            y0, x0 = (rng.integers(0, c // 2) for c in content_hw)
            h, w = (rng.integers(c // 8, c // 2) for c in content_hw)
            mask = np.zeros((S, S), bool)
            mask[y0:y0 + h, x0:x0 + w] = True
            pts[b, r] = ImageMapper.sample_region_points(mask, points, rng)
            valid[b, r] = True
    batch["region_points"] = pts
    batch["region_valid"] = valid
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


def load_eval_model(model_path: str, seg_task: SegTask,
                    cfg: Optional[PSALMConfig] = None):
    """(tokenizer, model, cfg) of an eval CLI called without a model: the
    checkpoint directory through ``load_pretrained_model`` on the card.
    Stops with an error when the directory holds no tokenizer."""
    from psalm_tpu_torch.models.builder import load_pretrained_model
    tokenizer, model, _ = load_pretrained_model(model_path, seg_task=seg_task,
                                                cfg=cfg, device="cuda")
    if tokenizer is None:
        raise SystemExit(
            f"{model_path} holds no tokenizer that transformers can load: "
            "the eval CLIs tokenize their prompts with the checkpoint's own "
            "(or pass tokenizer= to evaluation)")
    return tokenizer, model, model.cfg


class EvalRunner:
    def __init__(self, model, cfg: PSALMConfig, num_class_names=None,
                 is_thing=None, bucket_hw: Optional[Tuple[int, int]] = None):
        self.task = SegTask(cfg.seg_task.value)
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
        """The arrays the model reads, as tensors on the model's device (the
        ground truth stays on the host: only the metric accumulators read
        it)."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items() if k not in _HOST_ONLY}

    @staticmethod
    def _stack(per_image):
        """[{key: tensor}] per image -> {key: stacked tensor}."""
        return {k: torch.stack([d[k] for d in per_image]) for k in per_image[0]}

    def _label_map(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.uint8) if self.num_class_names <= 256 else x.int()

    @torch.no_grad()
    def _infer_device(self, tbatch: Dict[str, torch.Tensor], content: np.ndarray,
                      original: np.ndarray) -> Dict[str, Any]:
        task = self.task
        out = self.model(
            tbatch,
            use_class_names=task in (SegTask.PANOPTIC, SegTask.INSTANCE,
                                     SegTask.SEMANTIC),
            use_seg_embedding=task is SegTask.REFERRING,
            use_regions=task is SegTask.REGION,
            max_regions=(tbatch["region_points"].shape[1]
                         if "region_points" in tbatch else 0),
            num_class_names=self.num_class_names)
        masks = out["pred_masks"].float()  # [B, Q, S/4, S/4]
        B, Q = masks.shape[:2]
        S = self.cfg.image_size
        bucket = self.bucket_hw

        if task is SegTask.SEMANTIC:
            # head at the padded frame, then crop and resize: the class mix
            # commutes with the per-pixel linear restore, so the restore runs
            # on the Q sigmoid masks
            up = resize_bilinear(masks.reshape(B * Q, *masks.shape[2:], 1),
                                 (S, S)).reshape(B, Q, S, S)
            probs = torch.softmax(out["pred_class_name_logits"].float(),
                                  -1)[..., :-1]
            sems = [torch.einsum("qk,qhw->khw", probs[b],
                                 geometry.resize_to_original(
                                     torch.sigmoid(up[b]), content[b],
                                     original[b], bucket)).argmax(0)
                    for b in range(B)]
            return {"sem_seg": self._label_map(torch.stack(sems))}

        def restored(b):  # mask logits on the original grid, and its mask
            return (geometry.crop_resize_to_original(masks[b], content[b],
                                                     original[b], S, bucket),
                    geometry.valid_mask(original[b], bucket, self.device))

        if task is SegTask.PANOPTIC:
            logits = out["pred_class_name_logits"]
            is_thing = torch.as_tensor(self.is_thing, device=self.device)
            pans, infos, sems = [], [], []
            for b in range(B):
                mo, valid = restored(b)
                pan, info = postprocess.panoptic_inference(logits[b], mo,
                                                           is_thing, valid)
                pans.append(pan.to(torch.uint8) if Q <= 255 else pan)
                infos.append(info)
                sems.append(postprocess.semantic_inference(logits[b],
                                                           mo).argmax(0))
            return {"panoptic_seg": torch.stack(pans),
                    "segments": self._stack(infos),
                    "sem_seg": self._label_map(torch.stack(sems))}

        results = []
        for b in range(B):
            mo, valid = restored(b)
            mo = mo * valid[None].float()
            if task is SegTask.INSTANCE:
                results.append(postprocess.instance_inference(
                    out["pred_class_name_logits"][b], mo, topk=Q))
            elif task is SegTask.REFERRING:
                results.append(postprocess.seg_instance_inference(
                    out["pred_SEG_logits"][b], mo, topk=Q))
            else:
                results.append(postprocess.region_inference(
                    out["pred_region_logits"][b], mo))
        key = {SegTask.INSTANCE: "instances", SegTask.REFERRING: "referring",
               SegTask.REGION: "region"}[task]
        return {key: self._stack(results)}

    def infer(self, batch: Dict[str, np.ndarray],
              staged: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, Any]:
        if "original_hw" in batch:
            self._maybe_grow_bucket(batch)
        content = _content_hw(batch, self.cfg.image_size)
        if "original_hw" in batch:
            original = np.asarray(batch["original_hw"]).reshape(-1, 2)
        else:  # the reference's .get fallback: the content extent
            original = content
        if staged is None:
            staged = self.stage(batch)
        out = self._infer_device(staged, content, original)
        out = {k: ({n: t.cpu().numpy() for n, t in v.items()}
                   if isinstance(v, dict) else v.cpu().numpy())
               for k, v in out.items()}
        return self._crop_to_original(out, original)

    @staticmethod
    def _crop_to_original(out: Dict[str, Any], original_hw: np.ndarray
                          ) -> Dict[str, Any]:
        """Slice bucket-resolution maps and masks to each image's true
        (H, W); per-image shapes differ, so they become lists indexed by b
        (scores and classes stay stacked arrays)."""
        oh = np.asarray(original_hw).reshape(-1, 2)
        for key in ("panoptic_seg", "sem_seg"):
            if key in out:
                x = out[key]
                out[key] = [x[b, :oh[b, 0], :oh[b, 1]] for b in range(len(x))]
        for key in ("instances", "referring", "region"):
            if key in out:
                x = out[key]["masks"]
                out[key]["masks"] = [x[b, :, :oh[b, 0], :oh[b, 1]]
                                     for b in range(len(x))]
        return out

    # -- host-side geometric restore (ground truth stored at the padded
    # frame; predictions come back already at original resolution) ----------

    @staticmethod
    def restore_map(seg: np.ndarray, resized_hw, original_hw,
                    nearest: bool = True) -> np.ndarray:
        """Crop the content region and resize back to the original size."""
        import cv2
        nh, nw = resized_hw
        crop = seg[:nh, :nw]
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(np.asarray(crop), (original_hw[1], original_hw[0]),
                          interpolation=interp)

    @staticmethod
    def restore_masks(masks: np.ndarray, resized_hw, original_hw) -> np.ndarray:
        """[Q, S, S] -> [Q, H, W] via per-mask crop + nearest resize
        (threaded: cv2 releases the GIL)."""
        from concurrent.futures import ThreadPoolExecutor
        if len(masks) < 8:
            return np.stack([EvalRunner.restore_map(
                m.astype(np.uint8), resized_hw, original_hw) for m in masks])
        with ThreadPoolExecutor(max_workers=8) as ex:
            out = list(ex.map(lambda m: EvalRunner.restore_map(
                m.astype(np.uint8), resized_hw, original_hw), masks))
        return np.stack(out)


class Prefetcher:
    """Overlap dataset IO/preprocessing with device execution: a background
    thread keeps ``depth`` ready batches ahead of the consumer. An exception
    in the producer is raised to the consumer at the batch it broke."""

    def __init__(self, iterator, depth: int = 2):
        import queue
        import threading
        self.q = queue.Queue(maxsize=depth)
        self._END = object()

        def worker():
            try:
                for item in iterator:
                    self.q.put((item, None))
            except Exception as e:  # noqa: BLE001 - handed to the consumer
                self.q.put((None, e))
            finally:
                self.q.put((self._END, None))

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item, err = self.q.get()
        if err is not None:
            raise err
        if item is self._END:
            raise StopIteration
        return item
