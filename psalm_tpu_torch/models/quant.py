"""Weight-only int8 and int4 linears for the Phi stack (the reference's
bitsandbytes ``load_8bit`` / ``load_4bit``).

Counterpart of ``psalm_tpu/models/quant.py``, on the port's state dict:

  QuantDense   ``weight`` int8 [out, in] (transposed like ``Dense``; JAX's
               ``kernel_q`` is [in, out]), ``scale`` f32 [out] per output
               channel, ``bias``. y = (x @ weight^T) * scale + bias.
  Quant4Dense  ``packed`` int8 [in/2, out], the half-split nibble packing
               (byte i holds input row i in its low nibble and row in/2 + i
               in its high nibble; JAX's ``kernel_q4``, byte for byte),
               ``scale`` f32 [in/g, out] group scales along the input axis,
               ``bias``. With ``storage="pallas"`` a call of at most 16 rows
               that ``int4_matvec_supported`` accepts goes to kernel K4
               (``ops/int4_matvec.py``); every other call, and every call
               with ``storage="packed"``, runs the packed plain math:
               per-group partial dots in the compute dtype, then the scales.
               ``storage="native"`` (JAX's unpacked ``jnp.int4 [in, out]``
               ``kernel_q4n``) keeps the same bytes and groups and runs the
               packed plain math too, never K4: JAX's native branch takes
               the same per-group dots in the same group order.

The quantizers compute in torch on the tensors' own device (the card, for a
full-size model) and are byte-identical to the numpy originals.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch
from torch import nn

from psalm_tpu_torch.models.layers import Dense, LoRADense
from psalm_tpu_torch.ops.int4_matvec import (check_weight, int4_matvec,
                                             int4_matvec_supported,
                                             unpack_int4)

GROUP = 64
STORAGES = ("packed", "native", "pallas")

# the weights that get quantized, psalm_tpu's QUANT_LAYER_NAMES of the Phi
# stack: model.layers.{i}.self_attn.{q,k,v}_proj/dense and mlp.fc1/fc2, or
# a LoRA layer's base weight there (...q_proj.base.weight); embeddings,
# lm_head and the vision stack stay full precision (Swin's blocks also have
# mlp.fc1/fc2)
_PHI_LINEAR = re.compile(
    r"^model\.layers\.\d+\.(self_attn\.(q_proj|k_proj|v_proj|dense)"
    r"|mlp\.(fc1|fc2))(\.base)?\.weight$")


class QuantDense(nn.Module):
    """``Dense`` with an int8 weight and a per-output-channel f32 scale."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = (x.to(dt) @ self.weight.to(dt).t()) * self.scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class Quant4Dense(nn.Module):
    """``Dense`` with a nibble-packed int4 weight and f32 group scales."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, group: int = GROUP,
                 storage: str = "packed", device=None):
        super().__init__()
        if storage not in STORAGES:
            raise ValueError(f"int4 storage {storage!r}: takes {STORAGES}")
        if in_features % 2:
            raise ValueError(f"in_features {in_features} must be even")
        self.dtype = dtype
        self.storage = storage
        self.in_features = in_features
        self.out_features = out_features
        # groups may not straddle the half boundary: shrink to the gcd, as
        # psalm_tpu's Quant4Dense and quantize_kernel_int4 do
        self.group = math.gcd(in_features // 2, group)
        self.register_buffer("packed", torch.zeros(
            in_features // 2, out_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            in_features // self.group, out_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)
        # K4's gate per row count, and the weight that passed K4's checks
        # (by identity and address: a moved or replaced buffer is checked
        # anew), so that a decode step pays neither per call
        self._supported: Dict[int, bool] = {}
        self._checked = None

    def _takes_kernel(self, rows: int) -> bool:
        ok = self._supported.get(rows)
        if ok is None:
            ok = self._supported[rows] = int4_matvec_supported(
                rows, self.in_features, self.out_features, self.group)
        return ok

    def _weight_checked(self, device: torch.device) -> bool:
        """Whether the buffers passed ``check_weight`` (run now if not). A
        CPU call takes the plain version and needs no check."""
        if device.type == "cpu":
            return False
        p, s = self.packed, self.scale
        key = (id(p), p.data_ptr(), id(s), s.data_ptr())
        if self._checked != key:
            check_weight(p, s, self.in_features, self.group)
            self._checked = key
        return True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        lead = x.shape[:-1]
        rows = math.prod(lead)
        if self.storage == "pallas" and self._takes_kernel(rows):
            y = int4_matvec(x.to(dt).reshape(rows, self.in_features),
                            self.packed, self.scale, self.group,
                            weight_checked=self._weight_checked(x.device))
            y = y.reshape(*lead, self.out_features).to(dt)
        else:  # prefill-shaped calls, and storages "packed" and "native"
            y = self._packed_math(x.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y

    def _packed_math(self, x: torch.Tensor) -> torch.Tensor:
        """psalm_tpu's packed einsum math (quant.py:146-164)."""
        dt = self.dtype
        G, g, N = self.in_features // self.group, self.group, self.out_features
        low, high = unpack_int4(self.packed)
        xg = x.reshape(*x.shape[:-1], 2, G // 2, g)
        p_lo = torch.einsum("...gd,gdo->...go", xg[..., 0, :, :],
                            low.reshape(G // 2, g, N).to(dt))
        p_hi = torch.einsum("...gd,gdo->...go", xg[..., 1, :, :],
                            high.reshape(G // 2, g, N).to(dt))
        part = torch.cat([p_lo, p_hi], dim=-2)  # [..., G, out]
        return torch.einsum("...go,go->...o", part, self.scale.to(part.dtype))


def make_dense(cfg, in_features: int, out_features: int, dtype=torch.float32,
               device=None) -> nn.Module:
    """The linear layer of a Phi config: ``LoRADense`` when ``cfg.lora_rank``
    > 0 (over a float or int8 base), else ``Dense``, ``QuantDense`` (8
    bits) or ``Quant4Dense`` (4 bits, in ``cfg.quant_storage``), as
    ``psalm_tpu/models/phi.py::_dense`` picks."""
    if cfg.lora_rank > 0:
        return LoRADense(in_features, out_features, cfg.lora_rank,
                         cfg.lora_alpha, dtype=dtype,
                         quant_bits=cfg.quant_bits, device=device)
    if cfg.quant_bits == 8:
        return QuantDense(in_features, out_features, dtype=dtype, device=device)
    if cfg.quant_bits == 4:
        return Quant4Dense(in_features, out_features, dtype=dtype,
                           storage=cfg.quant_storage, device=device)
    if cfg.quant_bits:
        raise ValueError(f"quant_bits={cfg.quant_bits}: takes 0, 4 or 8")
    return Dense(in_features, out_features, dtype=dtype, device=device)


def quantize_kernel(kernel: torch.Tensor):
    """[in, out] float -> (int8 [in, out], f32 scale [out]); the same bytes
    as psalm_tpu's numpy ``quantize_kernel``."""
    k = kernel.float().contiguous()
    amax = k.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(k / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_kernel_int4(kernel: torch.Tensor, group: int = GROUP):
    """[in, out] float -> (packed int8 [in/2, out], f32 scale [in/g, out]),
    the half-split packing; the same bytes as psalm_tpu's numpy
    ``quantize_kernel_int4``."""
    k = kernel.float().contiguous()  # outputs then come out row-major too
    in_f, out_f = k.shape
    if in_f % 2:
        raise ValueError(f"kernel {tuple(k.shape)}: in must be even")
    half = in_f // 2
    group = math.gcd(half, group)
    kg = k.reshape(in_f // group, group, out_f)
    amax = kg.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(kg / scale[:, None, :]), -7, 7).to(torch.int8)
    q = q.reshape(in_f, out_f).view(torch.uint8)
    packed = (q[half:] << 4) | (q[:half] & 0xF)
    return packed.view(torch.int8), scale


def _quantize_phi(sd: Dict[str, torch.Tensor], bits: int,
                  group: int = GROUP) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in sd.items():
        if not _PHI_LINEAR.match(key):
            out[key] = value
            continue
        prefix = key[:-len(".weight")]
        kernel = value.t()  # torch [out, in] -> the JAX layout [in, out]
        if bits == 8:
            q, scale = quantize_kernel(kernel)
            out[prefix + ".weight"] = q.t().contiguous()
        else:
            out[prefix + ".packed"], scale = quantize_kernel_int4(kernel, group)
        out[prefix + ".scale"] = scale
    return out


def quantize_phi_int8(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's state dict with every Phi linear weight, a LoRA layer's
    base weight included, replaced by an int8 ``weight`` and its ``scale``
    (``psalm_tpu``'s ``quantize_phi_int8``), on the tensors' device."""
    return _quantize_phi(sd, 8)


def quantize_phi_int4(sd: Dict[str, torch.Tensor], group: int = GROUP,
                      storage: str = "packed") -> Dict[str, torch.Tensor]:
    """The port's state dict with every Phi linear weight replaced by the
    ``packed`` int4 bytes and their group ``scale`` (``psalm_tpu``'s
    ``quantize_phi_int4``), on the tensors' device. ``storage`` is taken
    for JAX's signature and is only checked: it selects nothing, since the
    port keeps the same bytes for every storage (JAX's ``"native"``
    ``kernel_q4n`` holds the same values unpacked)."""
    if storage not in STORAGES:
        raise ValueError(f"int4 storage {storage!r}: takes {STORAGES}")
    return _quantize_phi(sd, 4, group)
