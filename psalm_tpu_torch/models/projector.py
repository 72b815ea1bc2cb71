"""The vision-to-LLM projectors, eval mode.

Counterpart of ``psalm_tpu/models/projector.py``: ``build_projector`` picks
by ``projector_type`` as the reference's ``build_vision_projector`` does
(multimodal_projector/builder.py:405-433):
  * ``swin_conv`` (PSALM's default), ``ResNetSwinProjector``: one stride-2
    BasicBlock (BatchNorm from the running statistics) followed by a linear
    map of every position to the LLM width. ``conv2`` is applied twice with
    shared weights, as the released model does (the reference quirk the JAX
    package keeps for checkpoint parity). res5 [B, H, W, C] gives
    (H/2)(W/2) tokens.
  * ``linear``, ``LinearProjector``: one linear map of every res5 position,
    H W tokens.
  * ``mlpNx_gelu``, ``MLPProjector``: Linear, then N - 1 times exact GELU
    and Linear, H W tokens.

Parameter names are the released checkpoint's: ``model.mm_projector.*``
(``layer1.0.*`` and ``fc`` for swin_conv; ``weight`` and ``bias`` for
linear; ``0``, ``2``, ``4``, ... for the linears of mlpNx_gelu's
``nn.Sequential``, the GELUs between them).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from psalm_tpu_torch.config import ProjectorConfig
from psalm_tpu_torch.models.layers import BatchNorm2d, Conv2d, Dense


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=2, padding=1,
                            bias=False, dtype=dtype, device=device)
        self.bn1 = BatchNorm2d(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, stride=1, padding=1, bias=False,
                            dtype=dtype, device=device)
        self.bn2 = BatchNorm2d(planes, device=device)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes, 1, stride=2, bias=False, dtype=dtype,
                   device=device),
            BatchNorm2d(planes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(self.conv2(out)))
        return F.relu(out + self.downsample(x))


class ResNetSwinProjector(nn.Module):
    """res5 [B, H, W, C_in] -> tokens [B, (H/2)*(W/2), out_dim]."""

    def __init__(self, cfg: ProjectorConfig, dtype=torch.float32, device=None):
        super().__init__()
        planes = 2 * cfg.input_dim
        self.layer1 = nn.ModuleList(
            [BasicBlock(cfg.input_dim, planes, dtype=dtype, device=device)])
        self.fc = Dense(planes, cfg.out_dim, dtype=dtype, device=device)

    def forward(self, res5: torch.Tensor) -> torch.Tensor:
        out = self.layer1[0](res5)
        B, H, W, C = out.shape
        return self.fc(out.reshape(B, H * W, C))


def _positions(feats: torch.Tensor) -> torch.Tensor:
    """[B, ..., C] -> [B, N, C], every position a token."""
    return feats.reshape(feats.shape[0], -1, feats.shape[-1])


class LinearProjector(Dense):
    """projector_type='linear': res5 [B, H, W, C_in] -> [B, H*W, out_dim]."""

    def __init__(self, cfg: ProjectorConfig, dtype=torch.float32, device=None):
        super().__init__(cfg.input_dim, cfg.out_dim, dtype=dtype,
                         device=device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return super().forward(_positions(feats))


class MLPProjector(nn.Sequential):
    """projector_type='mlpNx_gelu': Linear + (depth - 1) x [GELU (exact,
    erf), Linear]; res5 [B, H, W, C_in] -> [B, H*W, out_dim]."""

    def __init__(self, cfg: ProjectorConfig, depth: int = 2,
                 dtype=torch.float32, device=None):
        mods = [Dense(cfg.input_dim, cfg.out_dim, dtype=dtype, device=device)]
        for _ in range(1, depth):
            mods += [nn.GELU(),
                     Dense(cfg.out_dim, cfg.out_dim, dtype=dtype,
                           device=device)]
        super().__init__(*mods)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return super().forward(_positions(feats))


def build_projector(cfg: ProjectorConfig, dtype=torch.float32,
                    device=None) -> nn.Module:
    """The projector of ``cfg.projector_type``: swin_conv | linear |
    mlpNx_gelu (``psalm_tpu/models/projector.py::build_projector``)."""
    t = cfg.projector_type
    if t == "swin_conv":
        return ResNetSwinProjector(cfg, dtype=dtype, device=device)
    if t == "linear":
        return LinearProjector(cfg, dtype=dtype, device=device)
    m = re.match(r"^mlp(\d+)x_gelu$", t)
    if m:
        return MLPProjector(cfg, depth=int(m.group(1)), dtype=dtype,
                            device=device)
    raise ValueError(f"unknown projector_type {t!r}")
