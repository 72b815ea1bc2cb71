"""Model loading for serving (the reference's psalm/model/builder.py:27-72).

Counterpart of ``psalm_tpu/models/builder.py::load_pretrained_model`` for a
released-format checkpoint directory: ``pytorch_model*.bin`` files (and
``*.safetensors`` when the ``safetensors`` package imports), whose keys are
the port's parameter names, plus the HF tokenizer in the same directory and
an optional ``psalm_tpu_config.json``. The weights go to ``device`` and are
quantized there (``load_8bit`` / ``load_4bit``, ``models/quant.py``); they
are stored in ``param_dtype`` (by default the compute ``dtype``): every
float tensor but the quantization ``scale``s and the BatchNorm statistics,
which stay f32. A training init keeps f32 parameters under bf16
compute (``param_dtype=torch.float32``) and passes PSALM's training options
(``remat``, ``remat_pixel``, ``train_backbone``). With ``cfg.phi.lora_rank``
> 0 the released Phi linears are grafted under the LoRA layers' ``base.``
(``train/lora.py::graft_base_params``) and the adapters are drawn from
``lora_seed``. With ``mesh=`` among the options (``PSALM(..., mesh=)``),
each rank keeps its slices of the loaded state dict
(``parallel.mesh.shard_state_dict``). Orbax directories (the JAX package's
own checkpoints) need JAX's stack to read: they raise
``NotImplementedError`` naming ``tools/orbax_to_torch.py``, which converts
one into such a directory.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from psalm_tpu_torch.config import PSALMConfig, SegTask, config_from_json
from psalm_tpu_torch.models.layers import LoRADense
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.models.quant import quantize_phi_int4, quantize_phi_int8
from psalm_tpu_torch.parallel.mesh import shard_state_dict
from psalm_tpu_torch.train.lora import graft_base_params, is_lora

# float tensors a bf16 load keeps in f32
KEEP_F32 = (".scale", ".running_mean", ".running_var")


def load_state_dict_files(model_path: str) -> Dict[str, torch.Tensor]:
    """One flat state dict from a checkpoint directory's weight files: the
    safetensors shards where there are some and the package imports, else
    the pytorch_model*.bin files."""
    files = sorted(os.listdir(model_path))
    names = [f for f in files if f.endswith(".safetensors")]
    load = None
    if names:
        try:
            from safetensors.torch import load_file as load
        except ImportError:
            pass
    if load is None:
        names = [f for f in files if re.match(r"pytorch_model.*\.bin$", f)]

        def load(path):
            return torch.load(path, map_location="cpu", weights_only=True)

    sd: Dict[str, torch.Tensor] = {}
    for f in names:
        sd.update(load(os.path.join(model_path, f)))
    if not sd:
        raise FileNotFoundError(f"no weights found in {model_path}")
    return sd


def model_from_state_dict(sd: Dict[str, Any], cfg: PSALMConfig,
                          dtype=torch.float32, load_8bit: bool = False,
                          load_4bit: bool = False, device="cuda",
                          param_dtype=None, lora_seed: int = 0,
                          **model_kwargs) -> PSALM:
    """A PSALM on ``device`` holding ``sd`` (released keys, float Phi
    linears), quantized, cast and, for a LoRA config, grafted there as
    ``load_pretrained_model`` does."""
    if load_8bit and load_4bit:
        raise ValueError("load_8bit and load_4bit exclude each other")
    bits = 8 if load_8bit else 4 if load_4bit else cfg.phi.quant_bits
    cfg = cfg.replace(phi=dataclasses.replace(cfg.phi, quant_bits=bits))
    sd = {k: torch.as_tensor(v).to(device) for k, v in sd.items()}
    if load_8bit:
        sd = quantize_phi_int8(sd)
    if load_4bit:
        sd = quantize_phi_int4(sd)
    store = dtype if param_dtype is None else param_dtype
    sd = {k: v.to(torch.float32 if k.endswith(KEEP_F32) else store)
          if v.is_floating_point() else v for k, v in sd.items()}
    model = PSALM(cfg, dtype=dtype, device=device, **model_kwargs)
    if cfg.phi.lora_rank > 0:
        generator = torch.Generator(device=device).manual_seed(lora_seed)
        for mod in model.modules():
            if isinstance(mod, LoRADense):
                mod.reset_adapters(generator)
        lora_sd = model.state_dict()
        missing = [k for k in lora_sd if not is_lora(k)
                   and k.replace(".base.", ".") not in sd and k not in sd]
        if missing:
            raise KeyError(f"the checkpoint lacks {missing[:5]}")
        sd = graft_base_params(lora_sd, sd)
    if model_kwargs.get("mesh") is not None:
        sd = shard_state_dict(sd, model_kwargs["mesh"], cfg)
    model.load_state_dict(sd, assign=True)
    return model.eval()


def load_pretrained_model(model_path: str,
                          seg_task: SegTask = SegTask.PANOPTIC,
                          dtype=torch.float32,
                          cfg: Optional[PSALMConfig] = None,
                          load_8bit: bool = False, load_4bit: bool = False,
                          device="cuda", param_dtype=None, lora_seed: int = 0,
                          **model_kwargs) -> Tuple[Any, PSALM, int]:
    """Returns (tokenizer, model, context_len); the tokenizer is None when
    the directory has none that ``transformers`` can load. ``dtype`` is
    the compute type, ``param_dtype`` the parameters' (``dtype`` by
    default); ``model_kwargs`` go to ``PSALM``."""
    if not os.path.isdir(model_path):
        raise FileNotFoundError(f"{model_path} is not a checkpoint directory")
    if os.path.exists(os.path.join(model_path, "_METADATA")) or \
            os.path.exists(os.path.join(model_path, "manifest.ocdbt")):
        raise NotImplementedError(
            f"{model_path} is an orbax checkpoint of psalm_tpu; reading one "
            "needs JAX: convert it where JAX is installed with python3 "
            f"tools/orbax_to_torch.py --orbax {model_path} --out DIR and "
            "load DIR")
    if cfg is None:
        # a converted checkpoint directory carries its own config
        cfg_path = os.path.join(model_path, "psalm_tpu_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = config_from_json(f.read()).replace(seg_task=seg_task)
        else:
            cfg = PSALMConfig(seg_task=seg_task)
    model = model_from_state_dict(load_state_dict_files(model_path), cfg,
                                  dtype, load_8bit, load_4bit, device,
                                  param_dtype, lora_seed, **model_kwargs)

    tokenizer = None
    try:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(model_path)
        if "[SEG]" not in tokenizer.get_vocab():
            tokenizer.add_tokens("[SEG]")
    except Exception:  # noqa: BLE001 - no tokenizer in the directory
        pass
    return tokenizer, model, model.cfg.phi.max_position_embeddings
