"""The checkpoint tools: psalm_tpu's orbax checkpoints into the port, and a
Mask2Former .pkl as the port's state-dict slices (tiny config, the CPU).

  * ``tools/orbax_to_torch.py`` on an orbax directory written by
    ``psalm_tpu.checkpoint.convert.save_orbax`` (the variables, as JAX's
    converter writes them, or a JAX Trainer's checkpoint layout) gives a
    directory that ``load_pretrained_model(device="cpu")`` loads into the
    same state dict, bit for bit, with the config and the tokenizer files;
    the builder's error on an orbax directory names the tool.
  * ``convert_mask2former_pkl`` on a synthetic Detectron2 .pkl gives the
    same tower and pixel-decoder tensors as JAX's ``convert_mask2former_pkl``
    carried across by ``checkpoint/from_jax.py``, the predictor's after the
    same surgery, and drops the keys PSALM does not have.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_modules import parity_state_dict

from psalm_tpu.checkpoint.convert import (convert_mask2former_pkl as jm2f,
                                          convert_psalm_checkpoint,
                                          save_orbax)
from psalm_tpu.config import config_to_json, tiny_test_config as jtiny
from psalm_tpu_torch.checkpoint import from_jax
from psalm_tpu_torch.checkpoint.mask2former import convert_mask2former_pkl
from psalm_tpu_torch.config import tiny_test_config
from psalm_tpu_torch.models.builder import load_pretrained_model

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import orbax_to_torch  # noqa: E402


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The parity state dict as JAX's variables in two orbax layouts."""
    cfg = jtiny()
    sd = parity_state_dict(cfg, seed=3)
    variables = convert_psalm_checkpoint(sd, cfg)
    dirs = {}
    for layout, tree in (("variables", variables),
                         ("trainer", {"params": variables,
                                      "step": np.asarray(3)})):
        path = str(tmp_path_factory.mktemp(layout) / "orbax")
        save_orbax(tree, path)
        with open(os.path.join(path, "psalm_tpu_config.json"), "w") as f:
            f.write(config_to_json(cfg))
        with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
            f.write("{}")
        dirs[layout] = path
    return sd, dirs


@pytest.mark.parametrize("layout", ["variables", "trainer"])
def test_orbax_tool_round_trip(saved, layout, tmp_path):
    sd, dirs = saved
    out = str(tmp_path / "port")
    orbax_to_torch.main(["--orbax", dirs[layout], "--out", out])
    assert {"pytorch_model.bin", "psalm_tpu_config.json",
            "special_tokens_map.json"} <= set(os.listdir(out))
    _, model, _ = load_pretrained_model(out, device="cpu")
    assert model.cfg.phi == tiny_test_config().phi
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k


def test_builder_names_the_tool_for_orbax(saved):
    _, dirs = saved
    with pytest.raises(NotImplementedError, match="tools/orbax_to_torch.py"):
        load_pretrained_model(dirs["variables"], device="cpu")


_SURGERY = {"adapter_1.0.weight": "adapter_1.weight",
            "adapter_1.1.weight": "adapter_1.norm.weight",
            "adapter_1.1.bias": "adapter_1.norm.bias",
            "layer_1.0.weight": "layer_1.weight",
            "layer_1.1.weight": "layer_1.norm.weight",
            "layer_1.1.bias": "layer_1.norm.bias"}


def _mask2former_pkl(sd, path, queries=None):
    """A Detectron2 Mask2Former checkpoint of the tiny model's tower, pixel
    decoder and predictor, in its own names, with a Swin buffer and a class
    head that PSALM does not have."""
    model = {}
    for k, v in sd.items():
        if k.startswith("model.vision_tower."):
            model["backbone." + k[len("model.vision_tower."):]] = v
        elif k.startswith("pixel_decoder."):
            k = k[len("pixel_decoder."):]
            model["sem_seg_head.pixel_decoder." + _SURGERY.get(k, k)] = v
        elif k.startswith("predictor."):
            k = k[len("predictor."):]
            if k == "query_feat.weight":
                k = "static_query.weight"
            model["sem_seg_head.predictor." + k] = v
    model["backbone.layers.0.blocks.0.attn.relative_position_index"] = \
        np.zeros((16, 16), np.int64)
    model["sem_seg_head.predictor.class_embed.weight"] = np.ones((6, 32),
                                                                 np.float32)
    if queries is not None:
        model["sem_seg_head.predictor.query_embed.weight"] = queries
    with open(path, "wb") as f:
        pickle.dump({"model": model, "__author__": "test"}, f)


def test_mask2former_surgery_equals_jax(tmp_path):
    jcfg, cfg = jtiny(), tiny_test_config()
    sd = parity_state_dict(jcfg, seed=6)
    path = str(tmp_path / "m2f.pkl")
    _mask2former_pkl(sd, path)
    got = convert_mask2former_pkl(path, cfg)
    want = {}
    jax_out = jm2f(path, jcfg)
    from_jax._swin(want, jax_out["vision_tower"], jcfg.swin.depths)
    from_jax._pixel_decoder(want, jax_out["pixel_decoder"],
                            jcfg.pixel_decoder.transformer_enc_layers,
                            jcfg.pixel_decoder.num_feature_levels)
    assert want and set(want) == {k for k in got
                                  if not k.startswith("predictor.")}
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(np.asarray(v))), k
    pred = {k for k in sd if k.startswith("predictor.")}
    assert {k for k in got if k.startswith("predictor.")} == pred
    for k in pred:
        assert torch.equal(got[k], torch.from_numpy(sd[k])), k
    assert not any("relative_position_index" in k or "class_embed" in k
                   for k in got)


def test_mask2former_keeps_100_of_200_query_rows(tmp_path):
    cfg = tiny_test_config()
    sd = parity_state_dict(jtiny(), seed=6)
    queries = np.arange(200 * 32, dtype=np.float32).reshape(200, 32)
    path = str(tmp_path / "m2f.pkl")
    _mask2former_pkl(sd, path, queries=queries)
    got = convert_mask2former_pkl(path, cfg)["predictor.query_embed.weight"]
    assert torch.equal(got, torch.from_numpy(queries[:100]))
