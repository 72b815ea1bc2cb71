"""The eval heads of the reference: a frozen copy of the port's
``eval/runner.py::EvalRunner._infer_device`` and ``_crop_to_original`` for
the panoptic and referring tasks, on the reference's model outputs: the
mask logits restored to the original pixel grid (crop, then resize, by
interpolation matrices on the bucket grid, f32), then the task's head, then
each map cropped to its original size.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from h100_bench.reference import geometry, postprocess


def panoptic(out: Dict[str, torch.Tensor], content: np.ndarray,
             original: np.ndarray, image_size: int, bucket, is_thing
             ) -> List[Dict[str, np.ndarray]]:
    """Per image: ``panoptic_seg`` [H, W], its ``segments`` (id, category,
    isthing, valid per query) and ``sem_seg`` [H, W], on the host, and the
    semantic scores on the bucket grid ``sem_scores`` [K - 1, Hb, Wb] on
    the device."""
    masks = out["pred_masks"].float()
    logits = out["pred_class_name_logits"]
    is_thing = torch.as_tensor(is_thing, device=masks.device)
    results = []
    for b in range(masks.shape[0]):
        mo = geometry.crop_resize_to_original(masks[b], content[b],
                                              original[b], image_size, bucket)
        valid = geometry.valid_mask(original[b], bucket, masks.device)
        pan, info = postprocess.panoptic_inference(logits[b], mo, is_thing,
                                                   valid)
        scores = postprocess.semantic_inference(logits[b], mo)
        h, w = (int(v) for v in original[b])
        results.append({"panoptic_seg": pan[:h, :w].cpu().numpy(),
                        "segments": {k: v.cpu().numpy()
                                     for k, v in info.items()},
                        "sem_seg": scores.argmax(0)[:h, :w].cpu().numpy(),
                        "sem_scores": scores})
    return results


def referring(out: Dict[str, torch.Tensor], content: np.ndarray,
              original: np.ndarray, image_size: int, bucket
              ) -> List[Dict[str, Any]]:
    """Per image, for every query in query order: ``masks`` [Q, H, W] bool
    and ``scores`` [Q] (the head's top-k over all Q, put back in query
    order), on the device."""
    masks = out["pred_masks"].float()
    Q = masks.shape[1]
    results = []
    for b in range(masks.shape[0]):
        mo = geometry.crop_resize_to_original(masks[b], content[b],
                                              original[b], image_size, bucket)
        valid = geometry.valid_mask(original[b], bucket, masks.device)
        mo = mo * valid[None].float()
        r = postprocess.seg_instance_inference(out["pred_SEG_logits"][b], mo,
                                               topk=Q)
        order = torch.argsort(r["query"].long())
        h, w = (int(v) for v in original[b])
        results.append({"masks": r["masks"][order][:, :h, :w],
                        "scores": r["scores"][order]})
    return results
