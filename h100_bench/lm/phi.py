"""Phi-1.5 (``reference/phi.py``) in PSALM's language-model slot: the
kind a configuration file has where it names none (``h100_bench/lm/``).

Counts: the reference computes the whole L x L score matrix of each layer
and masks it; the causal product that kernel K5 computes needs half of it,
2 L^2 D a layer for q k^T and P v together in place of 4 L^2 D, so
``num_layers`` x 2 L^2 D is taken off (``causal_saving``).
"""

from __future__ import annotations

import torch

from h100_bench.counts import ops
from h100_bench.reference.config import section
from h100_bench.reference.phi import PhiConfig, PhiModel

SECTION = "phi"

COUNTS_KEY = "phi"
COUNTS_LAYERS = "PSALM.model.layers."
COUNTS_NOTE = "Phi's attention causal"

#: K5, causal, where the eval model runs with ``use_flash``
SPANS = {"eval": [("psalm_tpu_torch.models.phi", "flash_attention", "flash",
                   ops.flash_attention_bound)]}


def parse(values) -> PhiConfig:
    return section(PhiConfig, values)


def build(cfg: PhiConfig, dtype=torch.float32, device=None,
          remat: bool = False) -> PhiModel:
    return PhiModel(cfg, dtype=dtype, device=device, remat=remat)


def draw_rules(module):
    """None: Phi's modules are the shared ones (``Dense``, ``LayerNorm``,
    ``nn.Embedding``)."""
    return None


def skipped_flops(cfg: PhiConfig, L: int):
    return {"causal_saving": cfg.num_layers * 2 * L * L * cfg.hidden_size}


def tiny() -> PhiConfig:
    return PhiConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                     num_layers=2, num_heads=2, max_position_embeddings=512)
