"""A Mask2Former checkpoint as the port's state-dict slices.

Counterpart of ``psalm_tpu/checkpoint/convert.py::convert_mask2former_pkl``
(:296-324), the reference's initialization key surgery
(llava_phi.py:195-219), on the port's names, which are the released
checkpoint's torch keys: a Detectron2 ``.pkl`` (``{"model": {name:
array}}``) has the Swin tower under ``backbone.``, the pixel decoder under
``sem_seg_head.pixel_decoder.`` and the predictor under
``sem_seg_head.predictor.``; the surgery renames the pixel decoder's fused
conv-norm keys (``adapter_1``, ``layer_1``) to their ``.0`` / ``.1`` form
and the predictor's ``static_query`` to ``query_feat``, and keeps the first
100 of 200 ``query_embed`` rows. The slices are the keys of a PSALM of
``cfg`` under ``model.vision_tower.``, ``pixel_decoder.`` and
``predictor.``; the checkpoint's other keys (Detectron2's buffers, heads
PSALM does not have) are dropped, as JAX's conversion drops what it does
not read. Load them with ``model.load_state_dict(slices, strict=False)``.

Both packages parse ``--mask2former_ckpt`` and leave it unused
(``psalm_tpu/train/train.py:49``).
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

_PIXEL_DECODER = [("adapter_1.weight", "adapter_1.0.weight"),
                  ("adapter_1.norm.weight", "adapter_1.1.weight"),
                  ("adapter_1.norm.bias", "adapter_1.1.bias"),
                  ("layer_1.weight", "layer_1.0.weight"),
                  ("layer_1.norm.weight", "layer_1.1.weight"),
                  ("layer_1.norm.bias", "layer_1.1.bias")]


def _sub(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_mask2former_pkl(path: str, cfg) -> Dict[str, torch.Tensor]:
    """The Mask2Former ``.pkl`` at ``path`` (a file this program's user
    trusts: unpickling runs its code) -> {port name: tensor} for the tower,
    the pixel decoder and the predictor of a PSALM of ``cfg``."""
    from psalm_tpu_torch.models.psalm import PSALM
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    sd = ckpt.get("model", ckpt)
    pd_sd = _sub(sd, "sem_seg_head.pixel_decoder.")
    pred_sd = _sub(sd, "sem_seg_head.predictor.")
    for old, new in _PIXEL_DECODER:
        if old in pd_sd:
            pd_sd[new] = pd_sd.pop(old)
    if "static_query.weight" in pred_sd:
        pred_sd["query_feat.weight"] = pred_sd.pop("static_query.weight")
    if "query_embed.weight" in pred_sd and \
            np.shape(pred_sd["query_embed.weight"])[0] == 200:
        pred_sd["query_embed.weight"] = pred_sd["query_embed.weight"][:100]
    named = {**{"model.vision_tower." + k: v
                for k, v in _sub(sd, "backbone.").items()},
             **{"pixel_decoder." + k: v for k, v in pd_sd.items()},
             **{"predictor." + k: v for k, v in pred_sd.items()}}
    keys = PSALM(cfg, device="meta").state_dict().keys()
    return {k: torch.as_tensor(np.asarray(v)) for k, v in named.items()
            if k in keys}
