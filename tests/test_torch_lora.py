"""The port's LoRA (``models/layers.py::LoRADense``, ``train/lora.py``)
against psalm_tpu's on the CPU, tiny Phi config, f32: the cases of
tests/test_lora.py and of tests/test_quant.py's QLoRA test, held across the
two packages through ``checkpoint/from_jax.py``.

JAX's parameters (``init`` from a PRNG key) are carried to the port's
names, so both packages run the same weights and adapters. Tolerances: the
grafted zero-init model equals the base model to 1e-5 (JAX's test); the
merged model equals the adapted one to 1e-4 (JAX's test); the port's
outputs equal JAX's to 1e-4 of their largest magnitude and its adapter
gradients to 1e-3 of their magnitude, floored at DUST of the largest (f32
sums in another order, as tests/test_torch_modules.py and
tests/test_torch_train.py state); grafting and merging are exact up to one
f32 rounding.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from psalm_tpu.config import tiny_test_config
from psalm_tpu.models.phi import PhiForCausalLM as JPhiForCausalLM
from psalm_tpu.models.phi import PhiModel as JPhiModel
from psalm_tpu.train import lora as jlora
from psalm_tpu_torch.checkpoint import from_jax
from psalm_tpu_torch.models.layers import Dense, LoRADense
from psalm_tpu_torch.models.phi import PhiModel
from psalm_tpu_torch.models.quant import QuantDense, quantize_phi_int8
from psalm_tpu_torch.train import lora
from test_torch_modules import assert_close_rel
from test_torch_train import DUST

torch.backends.cuda.matmul.allow_tf32 = False


class PhiLM(nn.Module):
    """The port's Phi with its ``lm_head``, named as JAX's PhiForCausalLM
    converts (``model.*``, ``lm_head.*``)."""

    def __init__(self, cfg):
        super().__init__()
        self.model = PhiModel(cfg, device="cpu")
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size,
                             bias=cfg.lm_head_bias)

    def forward(self, ids):
        return self.lm_head(self.model(self.model.embed(ids)))


def _cfgs(**kw):
    base = tiny_test_config().phi
    return base, dataclasses.replace(base, lora_rank=4, **kw)


def _to_port(params, cfg):
    """JAX PhiForCausalLM params -> the port's state dict (numpy)."""
    sd = {}
    from_jax._phi(sd, params["model"], cfg.num_layers)
    from_jax._dense(sd, "lm_head", params["lm_head"])
    return sd


def _port(cfg, sd):
    model = PhiLM(cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model.eval()


@pytest.fixture(scope="module")
def lm():
    base_cfg, lora_cfg = _cfgs()
    ids = np.arange(12).reshape(1, 12) % base_cfg.vocab_size
    base_params = JPhiForCausalLM(base_cfg).init(
        jax.random.PRNGKey(0), input_ids=jnp.asarray(ids))["params"]
    lora_params = JPhiForCausalLM(lora_cfg).init(
        jax.random.PRNGKey(1), input_ids=jnp.asarray(ids))["params"]
    return base_cfg, lora_cfg, ids, base_params, lora_params


def _logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids)).numpy()


def test_grafted_zero_init_lora_equals_the_base(lm):
    base_cfg, lora_cfg, ids, base_params, lora_params = lm
    base_sd = _to_port(base_params, base_cfg)
    lora_sd = _to_port(lora_params, lora_cfg)
    grafted = lora.graft_base_params(lora_sd, base_sd)
    # the same tree as JAX's graft, carried across
    want_sd = _to_port(jlora.graft_base_params(lora_params, base_params),
                       lora_cfg)
    assert set(grafted) == set(want_sd)
    for k in grafted:
        np.testing.assert_array_equal(np.asarray(grafted[k]), want_sd[k], k)
    base_out = _logits(_port(base_cfg, base_sd), ids)
    got = _logits(_port(lora_cfg, grafted), ids)
    np.testing.assert_allclose(got, base_out, rtol=1e-5, atol=1e-5)
    want, _, _ = JPhiForCausalLM(lora_cfg).apply(
        {"params": jlora.graft_base_params(lora_params, base_params)},
        input_ids=jnp.asarray(ids))
    assert_close_rel(got, np.asarray(want))


def test_merged_model_equals_the_adapted_one(lm):
    base_cfg, lora_cfg, ids, base_params, lora_params = lm
    bumped = jax.tree_util.tree_map_with_path(
        lambda kp, x: x + 0.01 if any(getattr(k, "key", "") == "lora_B"
                                      for k in kp) else x,
        jlora.graft_base_params(lora_params, base_params))
    sd = _to_port(bumped, lora_cfg)
    adapted = _logits(_port(lora_cfg, sd), ids)
    merged_sd = lora.merge_lora({k: torch.from_numpy(np.array(v))
                                 for k, v in sd.items()},
                                alpha=lora_cfg.lora_alpha)
    merged = _logits(_port(base_cfg, merged_sd), ids)
    np.testing.assert_allclose(merged, adapted, rtol=1e-4, atol=1e-4)
    # the same weights as JAX's merge, carried across
    want = _to_port(jlora.merge_lora(jax.tree.map(np.asarray, bumped),
                                     alpha=lora_cfg.lora_alpha), base_cfg)
    assert set(merged_sd) == set(want)
    for k, v in merged_sd.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    jadapted, _, _ = JPhiForCausalLM(lora_cfg).apply({"params": bumped},
                                                      input_ids=jnp.asarray(ids))
    assert_close_rel(adapted, np.asarray(jadapted))


def _trainable_names(params, mask, convert):
    """The port names of JAX's masked-in leaves."""
    flags = convert(jax.tree.map(
        lambda p, m: np.full(np.shape(p), float(m)), params, mask))
    return {k for k, v in flags.items() if np.all(v == 1.0)}


def test_lora_optimizer_freezes_the_base(lm):
    _, lora_cfg, ids, _, lora_params = lm
    model = _port(lora_cfg, _to_port(lora_params, lora_cfg)).train()
    trainable = {n for n, m in lora.lora_mask(model).items() if m}
    assert trainable == _trainable_names(
        lora_params, jlora.lora_mask(lora_params),
        lambda t: _to_port(t, lora_cfg))
    opt = lora.lora_optimizer(model, lr=0.1, total_steps=10,
                              warmup_ratio=0.0)
    assert {id(p) for p in opt.params} == {
        id(p) for n, p in model.named_parameters() if n in trainable}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(2):  # the first update has lr 0 (optax's schedule)
        opt.zero_grad()
        (model(torch.from_numpy(ids)) ** 2).sum().mul(1e-6).backward()
        opt.step()
    for n, p in model.named_parameters():
        if n in trainable:
            assert p.grad is not None
        else:  # frozen: no gradient kept, no optimizer state, unchanged
            assert p.grad is None and not p.requires_grad, n
            assert torch.equal(p, before[n]), n
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters() if n in trainable)


def _phi_setup(lora_rank=4, seed=0):
    cfg = dataclasses.replace(tiny_test_config().phi, lora_rank=lora_rank,
                              quant_bits=8)
    rng = np.random.RandomState(seed)
    x = (rng.randn(1, 12, cfg.hidden_size) * 0.5).astype(np.float32)
    return cfg, x, np.ones((1, 12), np.int32)


def test_qlora_structure_and_finetune_partition():
    """Quantized base + LoRA adapters, both packages on JAX's weights: the
    int8 base sits under ``base``, the trainable set is the adapters on both
    sides, the outputs agree, and the adapters' gradients, through the int8
    base, agree."""
    cfg, x, mask = _phi_setup()
    jmodel = JPhiModel(cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), inputs_embeds=x,
                            attention_mask=mask)
    params = _random_base(variables["params"])
    sd = {k[len("model."):]: v for k, v in _phi_sd(params, cfg).items()}
    model = PhiModel(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    q = model.layers[0].self_attn.q_proj
    assert isinstance(q, LoRADense) and isinstance(q.base, QuantDense)
    assert q.base.weight.dtype == torch.int8

    mask_tree = jlora.psalm_finetune_mask({"phi": params})
    want = _trainable_names({"phi": params}, mask_tree, lambda t: {
        k[len("model."):]: v for k, v in _phi_sd(t["phi"], cfg).items()})
    tmask = lora.psalm_finetune_mask(model)
    trainable, frozen = lora.partition_params(
        dict(model.named_parameters()), tmask)
    assert set(trainable) == want and all(lora.is_lora(k) for k in trainable)
    assert lora.combine_params(trainable, frozen).keys() == \
        dict(model.named_parameters()).keys()

    opt = lora.psalm_finetune_optimizer(model, lr=1e-3, total_steps=10)
    assert len(opt.params) == len(trainable)
    out = model(torch.from_numpy(x), torch.from_numpy(mask))
    jout = jmodel.apply({"params": params}, inputs_embeds=x,
                        attention_mask=mask)[0]
    assert_close_rel(out.detach().numpy(), np.asarray(jout))
    # sum(out^2) of a LayerNorm's output (scale 1, bias 0) does not move
    # with its input, so the loss is a fixed random projection of out
    proj = np.random.default_rng(5).standard_normal(out.shape).astype(
        np.float32)
    (out.float() * torch.from_numpy(proj)).sum().backward()

    def jloss(tr):
        p = jlora.combine_params(tr, jfrozen)
        o = jmodel.apply({"params": p["phi"]}, inputs_embeds=x,
                         attention_mask=mask)[0]
        return jnp.sum(o.astype(jnp.float32) * proj)

    jtrain, jfrozen = jlora.partition_params({"phi": params}, mask_tree)
    assert any(v.dtype == jnp.int8 for v in jax.tree.leaves(jfrozen))
    jgrads = {k[len("model."):]: v for k, v in
              _phi_sd(jlora.combine_params(jax.grad(jloss)(jtrain),
                                           jax.tree.map(np.zeros_like,
                                                        jfrozen))["phi"],
                      cfg).items()}
    # a gradient below DUST of the largest is float dust, as in
    # tests/test_torch_train.py
    floor = DUST * max(np.abs(np.asarray(jgrads[n])).max() for n in trainable)
    for n, p in trainable.items():
        g = p.grad.numpy()
        assert np.isfinite(g).all()
        w = np.asarray(jgrads[n])
        assert np.abs(g - w).max() <= 1e-3 * max(np.abs(w).max(), floor), n
    assert any(p.grad.abs().max() > 0 for p in trainable.values())


def _random_base(params, seed=1):
    """JAX's QLoRA init holds zero int8 kernels and unit scales: random
    int8 kernels, scales of 0.5 / 127 and adapters B away from zero."""
    rng = np.random.default_rng(seed)

    def walk(node, parent=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif k == "kernel_q":
                out[k] = jnp.asarray(rng.integers(-127, 128, v.shape,
                                                  dtype=np.int8))
            elif k == "scale" and parent == "base":
                out[k] = jnp.full(v.shape, 0.5 / 127, jnp.float32)
            elif k == "lora_B":
                out[k] = v + 0.01
            else:
                out[k] = v
        return out

    return walk(params)


def _phi_sd(params, cfg):
    """A JAX PhiModel's params (which hold no embedding when it was built
    on input embeddings) -> the port's names, with a zero embedding."""
    sd = {}
    emb = {"embedding": np.zeros((cfg.vocab_size, cfg.hidden_size),
                                 np.float32)}
    from_jax._phi(sd, {"embed_tokens": emb, **params}, cfg.num_layers)
    return sd


def test_quantize_phi_int8_takes_lora_nodes():
    """quantize_phi_int8 quantizes a LoRA layer's base weight, as JAX's
    does on a {base, lora_A, lora_B} node, and leaves the adapters."""
    cfg = tiny_test_config()
    _, lora_cfg = _cfgs()
    params = JPhiForCausalLM(lora_cfg).init(
        jax.random.PRNGKey(3), input_ids=jnp.zeros((1, 4), jnp.int32))["params"]
    from psalm_tpu.models.quant import quantize_phi_int8 as jquantize
    want = _to_port(jquantize({"params": {"phi": params}})["params"]["phi"],
                    cfg.phi)
    got = quantize_phi_int8({k: torch.from_numpy(np.array(v)) for k, v in
                             _to_port(params, cfg.phi).items()})
    assert set(got) == set(want)
    assert "model.layers.0.self_attn.q_proj.base.scale" in got
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], k)


def test_builder_grafts_a_qlora_training_init(tmp_path):
    """load_pretrained_model on a LoRA config with load_8bit: the released
    Phi linears quantized under the adapters' ``base.``, the adapters drawn
    (B = 0), f32 parameters under the compute type; the zero-init adapters
    leave Phi's output as the plain int8 load gives it."""
    from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
    from psalm_tpu_torch.models.builder import load_pretrained_model
    from test_torch_modules import parity_state_dict
    cfg = tiny_test_config()
    sd = from_jax.jax_to_torch_state_dict(convert_psalm_checkpoint(
        parity_state_dict(cfg, seed=7), cfg), cfg)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               str(tmp_path / "pytorch_model.bin"))
    from psalm_tpu_torch.config import tiny_test_config as ttiny
    tcfg = ttiny()
    lcfg = tcfg.replace(phi=dataclasses.replace(tcfg.phi, lora_rank=4))
    _, model, _ = load_pretrained_model(str(tmp_path), cfg=lcfg,
                                        load_8bit=True, device="cpu",
                                        param_dtype=torch.float32,
                                        train_backbone=True)
    _, plain, _ = load_pretrained_model(str(tmp_path), cfg=tcfg,
                                        load_8bit=True, device="cpu")
    q = model.model.layers[0].self_attn.q_proj
    assert isinstance(q, LoRADense) and isinstance(q.base, QuantDense)
    assert torch.equal(q.base.weight,
                       plain.model.layers[0].self_attn.q_proj.weight)
    assert not q.lora_B.any() and q.lora_A.std() > 0.01
    assert model.train_backbone
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, tcfg.phi.hidden_size)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model.model(x), plain.model(x),
                                   rtol=1e-5, atol=1e-5)
