"""The language models that PSALM's slot can hold, one module a kind:
``h100_bench/lm/<kind>.py``, named by a configuration file's top-level
``"language_model"`` (``phi``, Phi-1.5, where the key is absent). A
configuration with another language model adds its kind's module; nothing
else of the harness reads the language model's config or names its
classes. The module gives:

* ``SECTION``: the name of its section of the file's ``"model"``, and
  ``parse(values)``: that section's config (missing keys at their
  defaults). The port reads the same section.
* ``build(cfg, dtype, device, remat)``: its reference language model in
  plain ``torch``, with ``embed(ids)``, ``forward(inputs_embeds,
  attention_mask)`` -> the last hidden state [B, L, D] (f32), and
  ``hidden_size``, ``vocab_size`` and ``lm_head_bias``. The reference PSALM
  adds ``vision_tower`` and ``mm_projector`` to it, so its tensors are
  ``model.*`` beside theirs.
* ``draw_rules(module)``: for a module of one of its own classes, how each
  of the module's tensors is drawn ({name in the module: (kind, scale)},
  as ``weights.spec`` reads them), else None.
* ``COUNTS_KEY``: its key in a counts file's ``modules``;
  ``COUNTS_LAYERS``: the ``FlopCounterMode`` name of its layers (one ending
  in "." sums the numbered children); ``skipped_flops(cfg, L)``: {name:
  FLOPs} of the work the reference does at sequence length ``L`` that the
  program's kernels skip (taken off, and written into the counts file);
  ``COUNTS_NOTE``: how the counts take it, for their ``derivation``.
* ``SPANS``: by driver (``eval``, ``train``), the (program module,
  attribute, span name, bound function) entries that driver wraps beside
  its shared ones (``common.Spans``); its bound functions are its own.
* ``tiny()``: its config at the CPU tests' size, hidden size 64.

Nothing here imports the program, JAX or Flax.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict

DEFAULT = "phi"


def kind_of(config: Dict[str, Any]) -> str:
    """The language model's kind of a configuration file."""
    return config.get("language_model", DEFAULT)


def module(kind: str) -> ModuleType:
    """The module of the language model ``kind``."""
    if not kind.isidentifier():
        raise ValueError(f"language model {kind!r}: not a module's name")
    name = f"{__name__}.{kind}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no language model {kind!r} (h100_bench/lm/"
                         f"{kind}.py)") from None


def of(config: Dict[str, Any]) -> ModuleType:
    """The module of a configuration file's language model."""
    return module(kind_of(config))
