"""Weight utilities on the port's state dicts: delta checkpoints,
consolidation and the legacy vision-tokenizer set-up.

Counterpart of ``psalm_tpu/checkpoint/weight_tools.py`` (reference spec:
psalm/model/make_delta.py, apply_delta.py, consolidate.py): a LLaVA-style
delta is the target minus the base key by key, except where the shapes
differ (a grown vocabulary's embedding), where the target is kept as it is;
applying it reverses that. The state dicts map the port's parameter names
(``PSALM.state_dict()``) to tensors; numpy arrays are taken too, and every
result is a tensor on the input's device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _zip(a: Mapping[str, Any], b: Mapping[str, Any], fn) -> StateDict:
    if set(a) != set(b):
        raise ValueError(f"state dicts differ in keys: only in the first "
                         f"{sorted(set(a) - set(b))[:5]}, only in the second "
                         f"{sorted(set(b) - set(a))[:5]}")
    return {k: fn(_t(a[k]), _t(b[k])) for k in a}


def make_delta(base_sd: Mapping[str, Any],
               target_sd: Mapping[str, Any]) -> StateDict:
    """delta = target - base, except tensors whose shapes differ (a resized
    vocabulary's embedding): kept as the raw target (make_delta.py:15)."""
    return _zip(base_sd, target_sd,
                lambda b, t: t - b if b.shape == t.shape else t)


def apply_delta(base_sd: Mapping[str, Any],
                delta_sd: Mapping[str, Any]) -> StateDict:
    """base + delta, except where the shapes differ: the delta's tensor."""
    return _zip(base_sd, delta_sd,
                lambda b, d: b + d if b.shape == d.shape else d)


def consolidate(sd: Mapping[str, Any], dtype=torch.float32) -> StateDict:
    """Every tensor cast to one dtype for release (consolidate.py:13)."""
    return {k: _t(v).to(dtype) for k, v in sd.items()}


def _row_mean(w: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """The mean of the rows of ``w`` [V, D] as [1, D], summed in numpy's
    order, as JAX's version sums them: over the rows of the embedding
    [V, D], and along the contiguous axis of the head's kernel [D, V]
    (``transposed``), so that the new rows are equal to the bit."""
    a = w.detach().float().cpu().numpy()
    m = (np.ascontiguousarray(a.T).mean(axis=1) if transposed
         else a.mean(axis=0))
    return torch.from_numpy(m[None]).to(w.device, w.dtype)


def initialize_vision_tokenizer(sd: Mapping[str, Any], tokenizer,
                                mm_use_im_patch_token: bool = False,
                                mm_use_im_start_end: bool = False,
                                pretrain_adapter_sd: Optional[
                                    Mapping[str, Any]] = None) -> StateDict:
    """Legacy LLaVA vision-tokenizer set-up (llava_arch.py:181-223).

    Adds <im_patch> and/or <im_start>/<im_end> to the tokenizer, grows Phi's
    embedding table and ``lm_head.weight`` (both [vocab, hidden]) to the new
    vocabulary with the mean of the existing rows, and (with
    ``mm_use_im_start_end`` and ``pretrain_adapter_sd``) takes the adapter
    checkpoint's ``model.embed_tokens.weight`` rows for the new tokens.
    Returns a new state dict; the input is not changed.
    """
    from psalm_tpu_torch.data.constants import (DEFAULT_IM_END_TOKEN,
                                                DEFAULT_IM_START_TOKEN,
                                                DEFAULT_IMAGE_PATCH_TOKEN)

    num_new = 0
    if mm_use_im_patch_token:
        num_new += tokenizer.add_tokens([DEFAULT_IMAGE_PATCH_TOKEN],
                                        special_tokens=True)
    start_end_new = 0
    if mm_use_im_start_end:
        start_end_new = tokenizer.add_tokens(
            [DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
            special_tokens=True)
        num_new += start_end_new
    sd = {k: _t(v) for k, v in sd.items()}
    if num_new == 0:
        return sd

    emb = sd["model.embed_tokens.weight"].clone()
    head = sd["lm_head.weight"].clone()  # [V, D]
    grow = len(tokenizer) - emb.shape[0]
    if grow < 0:
        raise ValueError(f"tokenizer of {len(tokenizer)} tokens is smaller "
                         f"than the embedding's {emb.shape[0]} rows")
    if grow > 0:
        emb = torch.cat([emb, _row_mean(emb).expand(grow, -1)])
        head = torch.cat([head, _row_mean(head, transposed=True)
                          .expand(grow, -1)])

    if mm_use_im_start_end and pretrain_adapter_sd is not None:
        w = pretrain_adapter_sd.get("model.embed_tokens.weight")
        if w is not None:
            w = _t(w).to(emb.device, emb.dtype)
            if start_end_new != 2:
                raise ValueError(f"{start_end_new} start/end tokens added, "
                                 "expected 2")
            if w.shape == emb.shape:
                emb[-start_end_new:] = w[-start_end_new:]
            elif w.shape[0] == start_end_new:
                emb[-start_end_new:] = w
            else:
                raise ValueError(
                    f"Unexpected embed_tokens shape {tuple(w.shape)} for "
                    f"embedding {tuple(emb.shape)} with {start_end_new} new "
                    "tokens")

    return {**sd, "model.embed_tokens.weight": emb, "lm_head.weight": head}
