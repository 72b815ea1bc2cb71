#!/usr/bin/env python3
"""Convert a psalm_tpu orbax checkpoint into a psalm_tpu_torch checkpoint
directory. It runs where JAX, orbax and psalm_tpu are installed (the repo's
root on the path); the port itself never imports them.

    python3 tools/orbax_to_torch.py --orbax DIR --out OUT [--config_json F | --tiny]

DIR is what ``psalm_tpu/checkpoint/convert.py``'s command line writes (the
flax variables ``{"params", "batch_stats"}``, with ``psalm_tpu_config.json``
and the tokenizer files beside them) or a checkpoint of JAX's ``Trainer``
(``{"params": variables, "opt_state", "step"}``; the optimizer state is
left behind). It is read with ``psalm_tpu.checkpoint.convert.load_orbax``.
OUT gets what ``psalm_tpu_torch.models.builder.load_pretrained_model``
loads:
  pytorch_model.bin      the released checkpoint's torch state dict
                         (``checkpoint/from_jax.py::jax_to_torch_state_dict``);
  psalm_tpu_config.json  the config: --config_json, else DIR's own, else
                         the tiny test config with --tiny, else PSALMConfig();
  the tokenizer files    DIR's, copied as JAX's command line copies them.
"""

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def read_config(orbax_dir, config_json=None, tiny=False):
    """psalm_tpu's config for ``orbax_dir`` (see the module docstring)."""
    from psalm_tpu.config import PSALMConfig, config_from_json, tiny_test_config
    path = config_json or os.path.join(orbax_dir, "psalm_tpu_config.json")
    if os.path.exists(path):
        with open(path) as f:
            return config_from_json(f.read())
    if config_json:
        raise FileNotFoundError(config_json)
    return tiny_test_config() if tiny else PSALMConfig()


def convert(orbax_dir, out_dir, cfg):
    """Writes the port's checkpoint directory ``out_dir`` from
    ``orbax_dir``; returns its state dict (numpy)."""
    import torch

    from psalm_tpu.checkpoint.convert import _TOKENIZER_FILES, load_orbax
    from psalm_tpu.config import config_to_json
    from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
    restored = load_orbax(orbax_dir)
    variables = restored
    if "opt_state" in restored or "params" in restored.get("params", {}):
        variables = restored["params"]  # a Trainer checkpoint
    sd = jax_to_torch_state_dict(variables, cfg)
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()},
               os.path.join(out_dir, "pytorch_model.bin"))
    with open(os.path.join(out_dir, "psalm_tpu_config.json"), "w") as f:
        f.write(config_to_json(cfg))
    for name in _TOKENIZER_FILES:
        src = os.path.join(orbax_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, name))
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--orbax", required=True, help="psalm_tpu orbax directory")
    p.add_argument("--out", required=True,
                   help="psalm_tpu_torch checkpoint directory to write")
    p.add_argument("--config_json", default=None,
                   help="psalm_tpu config JSON (default: DIR's own)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_test_config() when DIR holds no config")
    args = p.parse_args(argv)
    cfg = read_config(args.orbax, args.config_json, args.tiny)
    sd = convert(args.orbax, args.out, cfg)
    print(f"wrote {len(sd)} tensors, the config and the tokenizer files "
          f"found to {args.out}")


if __name__ == "__main__":
    main()
