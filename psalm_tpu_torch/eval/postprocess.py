"""The segmentation inference heads, vectorized.

Counterpart of ``psalm_tpu/eval/postprocess.py``: ``semantic_inference``;
``panoptic_inference``, the reference's greedy panoptic merge loop expressed
with static shapes (per-pixel argmax over score-weighted masks, per-query
acceptance tests, stuff classes merged onto their first accepted query),
which gives the greedy loop's result because the argmax partition makes the
queries' pixel sets disjoint; and the instance, referring
(``seg_instance_inference``) and region heads: top-k scores, sigmoid masks
thresholded at 0.5, and each score times its mask's mean probability inside
the mask.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def semantic_inference(class_logits: torch.Tensor,
                       mask_logits: torch.Tensor) -> torch.Tensor:
    """class_logits [Q, K]; mask_logits [Q, H, W] -> [K-1, H, W]."""
    probs = torch.softmax(class_logits.float(), -1)[:, :-1]
    masks = torch.sigmoid(mask_logits.float())
    return torch.einsum("qc,qhw->chw", probs, masks)


def panoptic_inference(
    class_logits: torch.Tensor,                # [Q, K], background last
    mask_logits: torch.Tensor,                 # [Q, H, W]
    is_thing: torch.Tensor,                    # [K-1] bool
    valid_mask: Optional[torch.Tensor] = None,  # [H, W] bool
    object_mask_threshold: float = 0.8,
    overlap_threshold: float = 0.8,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (panoptic_seg [H, W] int32, 0 = void,
    dict(id [Q], category [Q], isthing [Q], valid [Q]))."""
    Q, K = class_logits.shape
    num_classes = K - 1
    dev = class_logits.device
    probs = torch.softmax(class_logits.float(), -1)
    scores = probs.max(-1).values
    labels = probs.argmax(-1)  # first maximum, as jnp.argmax
    masks = torch.sigmoid(mask_logits.float())
    if valid_mask is not None:
        masks = masks * valid_mask.float()[None]

    keep = (labels != num_classes) & (scores > object_mask_threshold)
    neg = torch.full_like(masks, -1.0)
    prob_masks = torch.where(keep[:, None, None], scores[:, None, None] * masks,
                             neg)
    mask_ids = prob_masks.argmax(0)  # [H, W]
    any_kept = keep.any()

    qidx = torch.arange(Q, device=dev)
    hard = masks >= 0.5
    win = mask_ids[None] == qidx[:, None, None]
    final = win & hard
    win_img = win if valid_mask is None else win & valid_mask[None]
    mask_area = (win_img & keep[:, None, None]).sum((1, 2))
    original_area = hard.sum((1, 2))
    final_area = final.sum((1, 2))
    accepted = (keep & (mask_area > 0) & (original_area > 0) & (final_area > 0)
                & (mask_area >= overlap_threshold * original_area) & any_kept)

    labels_c = labels.clamp(0, num_classes - 1)
    isthing = is_thing.to(dev)[labels_c] & accepted
    stuff = accepted & ~isthing
    same_class = labels_c[None, :] == labels_c[:, None]
    earlier_stuff = stuff[None, :] & same_class & (qidx[None, :] <= qidx[:, None])
    first_stuff = torch.where(earlier_stuff, qidx[None, :],
                              torch.full_like(earlier_stuff, Q, dtype=qidx.dtype)
                              ).min(-1).values
    canonical = torch.where(isthing, qidx, torch.where(stuff, first_stuff, qidx))
    is_canonical = accepted & (canonical == qidx)
    seg_id_of_canonical = torch.cumsum(is_canonical.int(), 0)
    seg_id = torch.where(accepted, seg_id_of_canonical[canonical],
                         torch.zeros_like(seg_id_of_canonical))
    contrib = torch.where(final & accepted[:, None, None], seg_id[:, None, None],
                          torch.zeros((), dtype=seg_id.dtype, device=dev))
    panoptic_seg = contrib.max(0).values.int()
    info = {
        "id": seg_id.int(),
        "category": labels_c.int(),
        "isthing": isthing,
        "valid": is_canonical,
    }
    return panoptic_seg, info


def _mask_scores(masks: torch.Tensor):
    """(hard masks > 0.5, mean probability inside each) of [k, H, W]
    probabilities."""
    hard = masks > 0.5
    return hard, (masks * hard).sum((1, 2)) / (hard.sum((1, 2)) + 1e-6)


def instance_inference(class_logits: torch.Tensor, mask_logits: torch.Tensor,
                       topk: int, is_thing: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """class_logits [Q, K]; mask_logits [Q, H, W]. The top ``topk`` (query,
    class) scores: dict(masks [k, H, W] bool, scores [k], classes [k],
    keep [k] bool, the thing filter)."""
    num_classes = class_logits.shape[1] - 1
    scores_all = torch.softmax(class_logits.float(), -1)[:, :-1]
    scores, idx = torch.topk(scores_all.reshape(-1), topk)
    labels = idx % num_classes
    hard, mask_scores = _mask_scores(
        torch.sigmoid(mask_logits.float())[idx // num_classes])
    keep = (torch.ones(topk, dtype=torch.bool, device=labels.device)
            if is_thing is None else is_thing.to(labels.device)[labels])
    return {"masks": hard, "scores": scores * mask_scores,
            "classes": labels.int(), "keep": keep}


def seg_instance_inference(SEG_logits: torch.Tensor, mask_logits: torch.Tensor,
                           topk: int) -> Dict[str, torch.Tensor]:
    """The referring head: SEG_logits [Q, 1]; mask_logits [Q, H, W] ->
    dict(masks [k, H, W] bool, scores [k], query [k])."""
    scores, idx = torch.topk(torch.sigmoid(SEG_logits.float()).reshape(-1),
                             topk)
    hard, mask_scores = _mask_scores(torch.sigmoid(mask_logits.float())[idx])
    return {"masks": hard, "scores": scores * mask_scores, "query": idx.int()}


def region_inference(region_logits: torch.Tensor, mask_logits: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """region_logits [R, Q]; mask_logits [Q, H, W] ->
    dict(masks [Q, H, W] bool, scores [Q, R])."""
    hard, mask_scores = _mask_scores(torch.sigmoid(mask_logits.float()))
    scores = torch.sigmoid(region_logits.float())
    return {"masks": hard, "scores": (scores * mask_scores[None, :]).T}
