"""The ``swin_conv`` vision-to-LLM projector (ResNetSwin), eval mode.

Counterpart of ``psalm_tpu/models/projector.py::ResNetSwinProjector``: one
stride-2 BasicBlock (BatchNorm from the running statistics) followed by a
linear map of every position to the LLM width. ``conv2`` is applied twice
with shared weights, as the released model does (the reference quirk the JAX
package keeps for checkpoint parity).

Parameter names are the released checkpoint's (``model.mm_projector.*``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from psalm_tpu.config import ProjectorConfig
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
        if cfg.projector_type != "swin_conv":
            raise NotImplementedError(
                f"projector_type {cfg.projector_type!r} is not ported")
        planes = 2 * cfg.input_dim
        self.layer1 = nn.ModuleList(
            [BasicBlock(cfg.input_dim, planes, dtype=dtype, device=device)])
        self.fc = Dense(planes, cfg.out_dim, dtype=dtype, device=device)

    def forward(self, res5: torch.Tensor) -> torch.Tensor:
        out = self.layer1[0](res5)
        B, H, W, C = out.shape
        return self.fc(out.reshape(B, H * W, C))
