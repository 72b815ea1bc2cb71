"""Random weights from a seed, made on the device in one call.

``spec(model)`` reads, from the reference's own modules, how each
parameter and float buffer is drawn (the JAX package's init recipe, as the
port's ``init_weights_`` states it: LeCun-normal linear and conv weights,
zero biases, unit norms, N(0, 1/D) token embeddings, N(0, 1) query and
level tables, N(0, 0.02) relative position bias tables, zero seg queries,
for each deformable attention a zero ``sampling_offsets`` weight with the
deformable-DETR bias and a zero ``attention_weights`` layer).
``fill(model, spec, seed, dtype)`` draws one flat N(0, 1) buffer of
``dtype`` with a ``torch.Generator`` on the model's device, seeded from
``seed``, and writes each tensor from its slice, scaled, or its constant.
The program's model and the reference's have the same names, so the same
seed gives both the same numbers: the reference's f32 parameters hold the
values the program's ``dtype`` parameters hold.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# (kind, std or constant) by name: "normal" draws std * N(0, 1), "const"
# fills a number, "offsets" is the deformable-DETR sampling bias
Spec = List[Tuple[str, str, float, Tuple[int, ...]]]


def spec(model) -> Spec:
    """How each of the reference model's parameters and float buffers is
    drawn, in ``named_parameters`` then ``named_buffers`` order."""
    from h100_bench.reference import layers
    from h100_bench.reference.mask_decoder import Table
    from h100_bench.reference.pixel_decoder import (MSDeformAttnLayer,
                                                    MSDeformAttnPixelDecoder)
    from h100_bench.reference.psalm import PSALM
    from h100_bench.reference.swin import WindowAttention
    rule: Dict[str, Tuple[str, float]] = {}
    for prefix, mod in model.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(mod, (layers.Dense, layers.Conv2d)):
            rule[p + "weight"] = ("normal",
                                  1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                rule[p + "bias"] = ("const", 0.0)
        elif isinstance(mod, layers.MultiheadAttention):
            rule[p + "in_proj_weight"] = ("normal", 1.0 / math.sqrt(mod.dim))
            rule[p + "in_proj_bias"] = ("const", 0.0)
        elif isinstance(mod, (layers.LayerNorm, layers.GroupNorm,
                              layers.BatchNorm2d)):
            rule[p + "weight"] = ("const", 1.0)
            rule[p + "bias"] = ("const", 0.0)
            if isinstance(mod, layers.BatchNorm2d):
                rule[p + "running_mean"] = ("const", 0.0)
                rule[p + "running_var"] = ("const", 1.0)
        elif isinstance(mod, torch.nn.Embedding):
            rule[p + "weight"] = ("normal",
                                  1.0 / math.sqrt(mod.weight.shape[1]))
        elif isinstance(mod, Table):
            rule[p + "weight"] = ("normal", 1.0)
        elif isinstance(mod, WindowAttention):
            rule[p + "relative_position_bias_table"] = ("normal", 0.02)
    for prefix, mod in model.named_modules():  # after the generic pass
        p = prefix + "." if prefix else ""
        if isinstance(mod, MSDeformAttnLayer):
            rule[p + "sampling_offsets.weight"] = ("const", 0.0)
            rule[p + "sampling_offsets.bias"] = ("offsets", 0.0)
            rule[p + "attention_weights.weight"] = ("const", 0.0)
            rule[p + "attention_weights.bias"] = ("const", 0.0)
        elif isinstance(mod, MSDeformAttnPixelDecoder):
            rule[p + "transformer.level_embed"] = ("normal", 1.0)
        elif isinstance(mod, PSALM):
            rule[p + "seg_query"] = ("const", 0.0)
    out: Spec = []
    names = [(n, t) for n, t in model.named_parameters()]
    names += [(n, t) for n, t in model.named_buffers()
              if t.is_floating_point()]
    for name, t in names:
        if name not in rule:
            raise KeyError(f"no rule draws {name}")
        kind, scale = rule[name]
        out.append((name, kind, scale, tuple(t.shape)))
    return out


def _offset_bias(prefix: str, model) -> np.ndarray:
    from h100_bench.reference.pixel_decoder import offset_bias_init
    layer = model.get_submodule(prefix)
    return offset_bias_init(layer.n_heads, layer.n_levels, layer.n_points)


@torch.no_grad()
def fill(model, spec_: Spec, seed: int, dtype: torch.dtype,
         reference=None) -> None:
    """Writes every tensor of ``spec_`` into ``model`` (found by name): one
    ``torch.randn`` of ``dtype`` on the model's device for all the drawn
    numbers, scaled per tensor. ``reference``: the module whose
    ``MSDeformAttnLayer``s give the offsets' shape (the reference model on
    any device; ``model`` itself by default)."""
    reference = reference if reference is not None else model
    tensors = dict(model.named_parameters())
    tensors.update(dict(model.named_buffers()))
    device = next(iter(tensors.values())).device
    total = sum(int(np.prod(shape)) for _, kind, _, shape in spec_
                if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    off = 0
    for name, kind, scale, shape in spec_:
        t = tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, spec {shape}")
        if kind == "normal":
            n = int(np.prod(shape))
            t.copy_((flat[off:off + n].view(shape) * scale).to(dtype))
            off += n
        elif kind == "const":
            t.fill_(scale)
        else:
            prefix = name.rsplit(".", 2)[0]
            bias = torch.from_numpy(_offset_bias(prefix, reference))
            t.copy_(bias.to(dtype))
    del flat


def reference_config(config):
    """The reference's PSALMConfig of a configuration file."""
    from h100_bench.reference.config import config_from_json
    return config_from_json(json.dumps(config["model"]))


def reference_model(cfg, device, remat: bool = False):
    """The reference PSALM in f32 on ``device`` (its tensors uninitialised:
    ``fill`` writes them)."""
    from h100_bench.reference.psalm import PSALM
    return PSALM(cfg, dtype=torch.float32, device=device, remat=remat)


def weight_spec(config):
    """(``spec``, the reference model on ``meta`` it was read from) of a
    configuration file."""
    meta = reference_model(reference_config(config), "meta")
    return spec(meta), meta
