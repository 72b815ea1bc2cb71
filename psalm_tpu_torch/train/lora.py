"""LoRA: the trainable masks, the masked optimizers, base-weight grafting,
merge for export, and state-dict splits.

Counterpart of ``psalm_tpu/train/lora.py`` on the port's parameter names
(``named_parameters()`` / ``state_dict()`` keys). A Phi with
``PhiConfig.lora_rank > 0`` holds ``LoRADense`` layers (``models/layers.py``):
``<name>.base.{weight, bias}`` (or the int8 ``base.weight`` and
``base.scale`` of QLoRA) beside ``<name>.lora_A`` [in, r] and
``<name>.lora_B`` [r, out]. Set the rank, build the model, graft the base
weights in (``graft_base_params``), train with ``lora_optimizer`` or
``psalm_finetune_optimizer``, and merge for export (``merge_lora``).

JAX's ``_masked_only`` zeroes the frozen leaves' updates and keeps no
optimizer state for them; here the frozen parameters get
``requires_grad_(False)`` (autograd then keeps no gradient for them either)
and the optimizer holds only the trainable ones.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple, Union

import torch
from torch import nn

from psalm_tpu_torch.train.train_step import Optimizer, make_optimizer

Names = Union[nn.Module, Iterable[str]]
StateDict = Dict[str, torch.Tensor]

# Phi's own parameters in a PSALM (model.embed_tokens, model.layers.*,
# model.final_layernorm, lm_head) or in a bare PhiModel (no "model.")
_PHI = re.compile(r"^(model\.)?(embed_tokens|layers|final_layernorm)\.|^lm_head\.")


def _names(params: Names):
    if isinstance(params, nn.Module):
        return [n for n, _ in params.named_parameters()]
    return list(params)


def is_lora(name: str) -> bool:
    return name.endswith((".lora_A", ".lora_B"))


def lora_mask(params: Names) -> Dict[str, bool]:
    """True for the trainable (LoRA adapter) names, False for the rest."""
    return {n: is_lora(n) for n in _names(params)}


def psalm_finetune_mask(params: Names) -> Dict[str, bool]:
    """The single-card PSALM finetune policy: the LoRA adapters and every
    module except the vision tower and Phi's base weights train."""
    return {n: is_lora(n) or not (n.startswith("model.vision_tower.")
                                  or _PHI.match(n))
            for n in _names(params)}


def _masked_only(model: nn.Module, mask: Dict[str, bool],
                 **optimizer_kwargs) -> Optimizer:
    trainable = []
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
        if mask[n]:
            trainable.append(p)
    return make_optimizer(trainable, **optimizer_kwargs)


def lora_optimizer(model: nn.Module, **optimizer_kwargs) -> Optimizer:
    """``train_step.make_optimizer`` (its keyword arguments) over the LoRA
    adapters alone; every other parameter is frozen."""
    return _masked_only(model, lora_mask(model), **optimizer_kwargs)


def psalm_finetune_optimizer(model: nn.Module,
                             **optimizer_kwargs) -> Optimizer:
    """``train_step.make_optimizer`` over ``psalm_finetune_mask``'s
    parameters; the tower and Phi's base are frozen."""
    return _masked_only(model, psalm_finetune_mask(model), **optimizer_kwargs)


def graft_base_params(lora_sd: StateDict, base_sd: StateDict) -> StateDict:
    """``lora_sd`` (a LoRA model's state dict, adapters initialized) with the
    base model's weights copied in: ``<name>.base.<leaf>`` takes the base's
    ``<name>.<leaf>``, every other key the base's value under its own name,
    and the adapters keep theirs. Keys the base lacks keep ``lora_sd``'s."""
    out = {}
    for k, v in lora_sd.items():
        plain = k.replace(".base.", ".")
        if is_lora(k):
            out[k] = v
        elif ".base." in k and plain in base_sd:
            out[k] = base_sd[plain]
        else:
            out[k] = base_sd.get(k, v)
    return out


def partition_params(sd: StateDict, mask: Dict[str, bool]
                     ) -> Tuple[StateDict, StateDict]:
    """(trainable, frozen) halves of a state dict by ``mask``."""
    return ({k: v for k, v in sd.items() if mask[k]},
            {k: v for k, v in sd.items() if not mask[k]})


def combine_params(trainable: StateDict, frozen: StateDict) -> StateDict:
    return {**frozen, **trainable}


def merge_lora(sd: StateDict, alpha: float = 16.0) -> StateDict:
    """Fold each adapter into its base for export: W' = W + (alpha / r)
    (A B)^T in torch's [out, in] orientation, under the plain layer's names
    (``<name>.weight``, ``<name>.bias``). An int8 base (QLoRA) is first
    taken back to its float weight, weight * scale per output row."""
    out = {k: v for k, v in sd.items()
           if ".base." not in k and not is_lora(k)}
    for key in sd:
        if not key.endswith(".lora_A"):
            continue
        name = key[:-len(".lora_A")]
        a, b = sd[key].float(), sd[name + ".lora_B"].float()
        w = sd[name + ".base.weight"]
        if name + ".base.scale" in sd:
            w = w.float() * sd[name + ".base.scale"].float()[:, None]
        out[name + ".weight"] = w.float() + (alpha / a.shape[-1]) * (a @ b).t()
        if name + ".base.bias" in sd:
            out[name + ".bias"] = sd[name + ".base.bias"]
    return out
