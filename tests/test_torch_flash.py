"""K5's plain version and the modules that call K5 against psalm_tpu on the
CPU, in f32.

The JAX side's flash branches call the stock TPU kernel
``jax.experimental.pallas.ops.tpu.flash_attention``; on the CPU it runs
under ``force_tpu_interpret_mode()``. The port's ``flash_attention`` takes
its plain version, ``flash_attention_ref``, for CPU tensors.

Tolerances: ``flash_attention_ref`` against the stock kernel 1e-5 absolute
(unit-variance inputs, outputs below 3 in magnitude; both take f32 products
in another order). Modules 1e-4 of the output's largest magnitude, as
``tests/test_torch_modules.py`` states.

Phi's flash branch has no padding mask: valid query rows of a right-padded
sequence are exact and pad rows are not, so those tests compare valid rows.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as stock_flash_attention)

from test_torch_modules import (assert_close_rel, load_port,
                                setup)  # noqa: F401 - the module fixture

from psalm_tpu.config import tiny_test_config
from psalm_tpu.models.phi import PhiModel as JPhiModel
from psalm_tpu.models.pixel_decoder import (
    DenseSelfAttention as JDenseSelfAttention,
    MSDeformAttnPixelDecoder as JPixelDecoder)
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.models.phi import PhiModel
from psalm_tpu_torch.models.pixel_decoder import (DenseSelfAttention,
                                                  MSDeformAttnPixelDecoder)
from psalm_tpu_torch.models.psalm import PSALM, init_weights_
from psalm_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(seed, B, h, L, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, L, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_ref_matches_the_stock_kernel(causal, hd):
    q, k, v = _qkv(hd, 1, 2, 256, hd)
    scale = hd ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = stock_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     sm_scale=scale)
    got = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, sm_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_ref_is_chunked_over_queries(monkeypatch):
    """Chunks of 7 query rows (a ragged last chunk) give the one-chunk
    result, causal and not."""
    q, k, v = map(torch.from_numpy, _qkv(5, 2, 3, 30, 32))
    for causal in (True, False):
        whole = fa.flash_attention_ref(q, k, v, causal=causal, sm_scale=0.2)
        monkeypatch.setattr(fa, "_REF_CHUNK_BYTES", 4 * 2 * 3 * 30 * 7)
        chunked = fa.flash_attention_ref(q, k, v, causal=causal, sm_scale=0.2)
        monkeypatch.undo()
        torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


def _phi_inputs(cfg, B=2, L=40, valid1=29):
    rng = np.random.default_rng(2)
    embeds = rng.standard_normal((B, L, cfg.phi.hidden_size)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, valid1:] = False  # right padding
    return embeds, mask


def test_phi_flash_matches_jax_flash_on_valid_rows(setup):  # noqa: F811
    """PhiModel(use_flash=True) against JAX's PhiModel(use_flash=True), whose
    stock kernel pads L=40 to 128 and runs in interpret mode; and against
    the port's own einsum branch."""
    cfg, variables, port = setup
    embeds, mask = _phi_inputs(cfg)
    with pltpu.force_tpu_interpret_mode():
        want, _ = JPhiModel(cfg.phi, use_flash=True).apply(
            {"params": variables["params"]["phi"]["model"]},
            jnp.asarray(embeds), jnp.asarray(mask))
    flash = PhiModel(cfg.phi, use_flash=True)
    flash.load_state_dict(port.model.state_dict(), strict=False)
    args = (torch.from_numpy(embeds), torch.from_numpy(mask))
    with torch.no_grad():
        got = flash(*args).numpy()
        einsum = port.model(*args).numpy()
    want = np.asarray(want)
    assert_close_rel(got[mask], want[mask])
    assert_close_rel(got[mask], einsum[mask])
    # pad rows attend to earlier pad keys in the flash branch only
    assert np.abs(got[~mask] - einsum[~mask]).max() > 1e-3


def test_phi_flash_branch_only_without_cache(setup, monkeypatch):  # noqa: F811
    """The K5 branch runs for a full sequence of more than one token and
    never with a KV cache (prefill or decode)."""
    cfg, _, port = setup
    calls = []
    real = fa.flash_attention_ref
    monkeypatch.setattr(fa, "flash_attention_ref",
                        lambda *a, **kw: calls.append(kw["causal"]) or real(*a, **kw))
    flash = PhiModel(cfg.phi, use_flash=True)
    flash.load_state_dict(port.model.state_dict(), strict=False)
    embeds, mask = _phi_inputs(cfg)
    x = torch.from_numpy(embeds)
    with torch.no_grad():
        flash(x, torch.from_numpy(mask))
        assert calls == [True] * cfg.phi.num_layers
        flash(x[:, :1])  # a single token takes the einsum branch
        cache = flash.init_cache(2, 64, dtype=torch.float32)
        flash(x, torch.from_numpy(mask), cache=cache)
        flash(x[:, :1], cache=cache)
    assert calls == [True] * cfg.phi.num_layers


def _dense_cfg(cfg, nheads=4):
    return dataclasses.replace(cfg.pixel_decoder, attention_mode="dense",
                               transformer_nheads=nheads)


def dense_mode_variables(variables, cfg, seed=0):
    """``variables`` with each pixel-decoder encoder layer's deformable
    attention replaced by a DenseSelfAttention's four linears: LeCun-normal
    kernels and small biases from ``seed``."""
    rng = np.random.default_rng(seed)
    C = cfg.pixel_decoder.conv_dim
    params = dict(variables["params"])
    pd = dict(params["pixel_decoder"])
    for i in range(cfg.pixel_decoder.transformer_enc_layers):
        layer = dict(pd[f"encoder_layer_{i}"])
        layer["self_attn"] = {
            n: {"kernel": jnp.asarray(rng.standard_normal((C, C)).astype(
                    np.float32) / np.sqrt(C)),
                "bias": jnp.asarray(0.1 * rng.standard_normal(C).astype(
                    np.float32))}
            for n in ("q_proj", "k_proj", "value_proj", "output_proj")}
        pd[f"encoder_layer_{i}"] = layer
    params = {**params, "pixel_decoder": pd}
    return {**variables, "params": params}


def test_dense_self_attention_matches_jax():
    rng = np.random.default_rng(7)
    B, S, C, h = 2, 84, 32, 4
    query, src = (rng.standard_normal((B, S, C)).astype(np.float32)
                  for _ in range(2))
    jmod = JDenseSelfAttention(C, h)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(query),
                       jnp.asarray(src))
    want = jmod.apply(params, jnp.asarray(query), jnp.asarray(src))
    mod = DenseSelfAttention(C, h)
    mod.load_state_dict({f"{n}.{w}": torch.from_numpy(np.array(
        p["kernel"].T if w == "weight" else p["bias"]))
        for n, p in params["params"].items() for w in ("weight", "bias")})
    with torch.no_grad():
        got = mod(torch.from_numpy(query), torch.from_numpy(src))
    assert_close_rel(got.numpy(), want)


def test_dense_pixel_decoder_matches_jax(setup):  # noqa: F811
    """attention_mode="dense" end to end, the parameters carried across by
    jax_to_torch_state_dict."""
    cfg, variables, _ = setup
    cfg = cfg.replace(pixel_decoder=_dense_cfg(cfg))
    variables = dense_mode_variables(variables, cfg)
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((2, 64 // s, 64 // s, ch)).astype(np.float32)
             for s, ch in zip((4, 8, 16, 32), cfg.pixel_decoder.in_channels)]
    want = JPixelDecoder(cfg.pixel_decoder).apply(
        {"params": variables["params"]["pixel_decoder"]},
        [jnp.asarray(f) for f in feats])
    port = load_port(PSALM(cfg, device="cpu"),
                     jax_to_torch_state_dict(variables, cfg))
    assert isinstance(port.pixel_decoder.transformer.encoder.layers[0].self_attn,
                      DenseSelfAttention)
    with torch.no_grad():
        got = port.pixel_decoder([torch.from_numpy(f) for f in feats])
    assert_close_rel(got[0].numpy(), want[0])
    for g, w in zip(got[2], want[2]):
        assert_close_rel(g.numpy(), w)


def test_dense_mode_builds_and_inits():
    """The dense pixel decoder takes JAX's parameter names and the init
    recipe's LeCun-normal linears; per-point radii still raise."""
    cfg = tiny_test_config()
    cfg = cfg.replace(pixel_decoder=_dense_cfg(cfg))
    model = init_weights_(PSALM(cfg, device="cpu"),
                          torch.Generator().manual_seed(0))
    layer = model.pixel_decoder.transformer.encoder.layers[0].self_attn
    names = sorted(n for n, _ in layer.named_parameters())
    assert names == sorted(f"{n}.{w}" for n in ("q_proj", "k_proj",
                                                  "value_proj", "output_proj")
                           for w in ("weight", "bias"))
    std = layer.q_proj.weight.std().item()
    assert 0.5 / np.sqrt(32) < std < 2.0 / np.sqrt(32)
    assert torch.count_nonzero(layer.q_proj.bias) == 0
    with pytest.raises(NotImplementedError, match="window_point_radii"):
        MSDeformAttnPixelDecoder(dataclasses.replace(
            cfg.pixel_decoder, attention_mode="window",
            window_point_radii=(2.0, 4.0, 6.0, 8.0)))
