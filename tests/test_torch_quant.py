"""The port's weight quantization and K4's plain version against psalm_tpu
on the CPU: the quantizers byte for byte, ``int4_matvec_ref`` exactly on the
layout cases of tests/test_int4_matvec.py and within that file's tolerance on
random values, the quantized layers (JAX's ``"native"`` ``jnp.int4``
storage among them, carried across in the packed bytes), and a quantized
Phi carried across by ``from_jax``.

Tolerances: the layers compute the same f32 products as JAX's ``"packed"``
and ``"native"`` paths (the port runs both storages through the packed
math) in another summation order, so 1e-5 of the output's magnitude; JAX's
``"pallas"`` storage runs its interpret-mode dots at bf16 precision, so
against it the tolerance of tests/test_quant.py:154-155 (rtol 2e-2, atol
2e-3); a whole quantized Phi 1e-4 of its output's magnitude, as the float
Phi in tests/test_torch_modules.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_modules import assert_close_rel, load_port, parity_state_dict

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu.models import quant as jquant
from psalm_tpu.models.phi import PhiModel as JPhiModel
from psalm_tpu.ops import int4_matvec as jk4
from psalm_tpu_torch import config as tconfig
from psalm_tpu_torch.checkpoint.from_jax import (jax_to_torch_state_dict,
                                                 pack_int4)
from psalm_tpu_torch.models import quant
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.ops import int4_matvec as k4

torch.backends.cuda.matmul.allow_tf32 = False


def _kernel(shape, seed):
    """A random [in, out] kernel with columns of several magnitudes, an
    all-zero column (scale 1) and exact ties at the rounding boundary."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(shape).astype(np.float32)
    k *= np.exp2(rng.integers(-6, 3, shape[1]))[None].astype(np.float32)
    k[:, 1] = 0.0
    k[0, 2], k[1, 2] = 127.0, 0.5  # q = round(0.5) = 0 (half to even)
    return k


@pytest.mark.parametrize("shape", [(64, 32), (96, 48), (2048, 16)])
def test_quantize_kernel_bytes_equal(shape):
    k = _kernel(shape, 0)
    wq, ws = jquant.quantize_kernel(k)
    tq, ts = quant.quantize_kernel(torch.from_numpy(k))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), wq)
    assert ts.numpy().tobytes() == ws.tobytes()


@pytest.mark.parametrize("shape,group", [
    ((128, 96), 64), ((256, 128), 32),
    ((96, 40), 64),    # half 48: group shrinks to gcd(48, 64) = 16
    ((132, 8), 64),    # half 66: group 2
])
def test_quantize_kernel_int4_bytes_equal(shape, group):
    k = _kernel(shape, 1)
    wp, ws = jquant.quantize_kernel_int4(k, group)
    tp, ts = quant.quantize_kernel_int4(torch.from_numpy(k), group)
    assert tp.dtype == torch.int8 and tuple(tp.shape) == wp.shape
    assert tp.numpy().tobytes() == wp.tobytes()
    assert ts.numpy().tobytes() == ws.tobytes()


def _dequant(packed, scale, K, group):
    p = np.asarray(packed)
    low = (p.astype(np.int8) << 4) >> 4
    high = p.astype(np.int8) >> 4
    q = np.concatenate([low, high], 0).astype(np.float32)
    G = K // group
    return (q.reshape(G, group, -1)
            * np.asarray(scale)[:, None, :]).reshape(K, -1)


# the cases of tests/test_int4_matvec.py::test_layout_exact
@pytest.mark.parametrize("K,N,group", [(256, 384, 64), (8192, 256, 64),
                                       (256, 256, 32)])
def test_ref_exact_on_one_hot_layout_cases(K, N, group):
    rng = np.random.RandomState(1)
    G, half = K // group, K // 2
    q = rng.randint(-7, 8, (K, N)).astype(np.int8)
    packed = ((q[half:].astype(np.uint8) << 4)
              | (q[:half].astype(np.uint8) & 0xF)).astype(np.int8)
    scale = np.exp2(rng.randint(-4, 3, (G, N))).astype(np.float32)
    rows = rng.permutation(K)[:8]
    x = np.zeros((8, K), np.float32)
    x[np.arange(8), rows] = 1.0
    want = _dequant(packed, scale, K, group)[rows]

    got = k4.int4_matvec_ref(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(packed), torch.from_numpy(scale),
                             group).numpy()
    np.testing.assert_array_equal(got, want)
    jx = jnp.asarray(x, jnp.bfloat16)
    args = (jnp.asarray(packed), jnp.asarray(scale), group)
    np.testing.assert_array_equal(
        got, np.asarray(jk4.int4_matvec(jx, *args, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jk4.int4_matvec_xla(jx, *args)))


# the cases of tests/test_int4_matvec.py::test_value_close
@pytest.mark.parametrize("B,K,N,group", [(1, 256, 384, 64), (4, 512, 128, 64),
                                         (1, 8192, 256, 64)])
def test_ref_value_close(B, K, N, group):
    rng = np.random.RandomState(0)
    w = rng.randn(K, N).astype(np.float32) * 0.02
    packed, scale = jquant.quantize_kernel_int4(w, group)
    x = jnp.asarray(rng.randn(B, K), jnp.bfloat16)
    x32 = np.asarray(x, np.float32)
    got = k4.int4_matvec_ref(torch.from_numpy(x32).bfloat16(),
                             torch.from_numpy(packed), torch.from_numpy(scale),
                             group).numpy()
    want = x32 @ _dequant(packed, scale, K, group)
    tol = 5e-3 * np.abs(want).max() + 2e-2 * np.abs(want)
    assert np.max(np.abs(got - want) - tol) < 0
    xla = np.asarray(jk4.int4_matvec_xla(x, jnp.asarray(packed),
                                         jnp.asarray(scale), group))
    assert_close_rel(got, xla, rel=1e-5)


@pytest.mark.parametrize("args", [
    (1, 255, 128, 64), (1, 256, 100, 64), (32, 256, 128, 64),
    (1, 256, 128, 0), (8, 2048, 8192, 64), (16, 8192, 2048, 64),
    (17, 2048, 2048, 64), (1, 64, 128, 32), (1, 6144, 256, 64),
    (1, 128, 128, 48)])
def test_supported_gate_matches_jax(args):
    assert k4.int4_matvec_supported(*args) == jk4.int4_matvec_supported(*args)


IN_F, OUT_F = 256, 128


@pytest.fixture(scope="module")
def layer_params():
    rng = np.random.RandomState(0)
    k = (rng.randn(IN_F, OUT_F) * 0.05).astype(np.float32)
    bias = (rng.randn(OUT_F) * 0.01).astype(np.float32)
    return k, bias


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(r, IN_F).astype(np.float32) for r in (1, 3, 64)] + \
        [rng.randn(2, 4, IN_F).astype(np.float32)]


def test_quant_dense_matches_jax(layer_params):
    k, bias = layer_params
    q, scale = jquant.quantize_kernel(k)
    jd = jquant.QuantDense(OUT_F, dtype=jnp.float32)
    params = {"params": {"kernel_q": jnp.asarray(q), "scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    td = quant.QuantDense(IN_F, OUT_F)
    td.load_state_dict({"weight": torch.from_numpy(q.T.copy()),
                        "scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    for x in _inputs(1):
        with torch.no_grad():
            got = td(torch.from_numpy(x)).numpy()
        assert_close_rel(got, jd.apply(params, jnp.asarray(x)), rel=1e-5)


@pytest.mark.parametrize("storage", ["packed", "pallas"])
def test_quant4_dense_matches_jax(layer_params, storage):
    """The port's "pallas" on the CPU sends decode-shaped calls to
    int4_matvec_ref and the rest to the packed math."""
    k, bias = layer_params
    packed, scale = jquant.quantize_kernel_int4(k, 64)
    params = {"params": {"kernel_q4": jnp.asarray(packed),
                         "scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    jp = jquant.Quant4Dense(OUT_F, group=64, dtype=jnp.float32)
    jk = jquant.Quant4Dense(OUT_F, group=64, dtype=jnp.float32,
                            storage="pallas")
    td = quant.Quant4Dense(IN_F, OUT_F, storage=storage)
    td.load_state_dict({"packed": torch.from_numpy(packed),
                        "scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    n = k4.LAUNCHES
    for x in _inputs(2):
        with torch.no_grad():
            got = td(torch.from_numpy(x)).numpy()
        assert got.shape == x.shape[:-1] + (OUT_F,)
        assert_close_rel(got, jp.apply(params, jnp.asarray(x)), rel=1e-5)
        np.testing.assert_allclose(got, np.asarray(jk.apply(params,
                                                            jnp.asarray(x))),
                                   rtol=2e-2, atol=2e-3)
    assert k4.LAUNCHES == n  # CPU tensors never launch K4


def test_native_storage_and_lora_raise():
    """Storage "native" is ported (the layer builds; an unknown storage
    raises, in the layer and in the quantizer); LoRA builds over a float or
    int8 base (tests/test_torch_lora.py) and raises over an int4 one."""
    assert quant.Quant4Dense(IN_F, OUT_F, storage="native").storage == "native"
    with pytest.raises(ValueError, match="int4 storage"):
        quant.Quant4Dense(IN_F, OUT_F, storage="nibbles")
    with pytest.raises(ValueError, match="int4 storage"):
        quant.quantize_phi_int4({}, storage="nibbles")
    cfg = tconfig.PhiConfig(hidden_size=64, num_heads=4, lora_rank=4)
    assert isinstance(quant.make_dense(cfg, 64, 64).base, quant.Dense)
    cfg8 = dataclasses.replace(cfg, quant_bits=8)
    assert isinstance(quant.make_dense(cfg8, 64, 64).base, quant.QuantDense)
    with pytest.raises(ValueError, match="LoRA"):
        quant.make_dense(dataclasses.replace(cfg, quant_bits=4), 64, 64)


@pytest.fixture(scope="module")
def tiny_variables():
    cfg = tiny_test_config()
    return cfg, jax.tree.map(np.asarray, convert_psalm_checkpoint(
        parity_state_dict(cfg, seed=2), cfg))


def _jax_quantize(variables, bits):
    if bits == 8:
        return jquant.quantize_phi_int8(variables)
    return jquant.quantize_phi_int4(variables)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizers_on_the_state_dict_match_jax(tiny_variables, bits):
    cfg, variables = tiny_variables
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jax_to_torch_state_dict(variables, cfg).items()}
    got = (quant.quantize_phi_int8 if bits == 8 else quant.quantize_phi_int4)(sd)
    want = jax_to_torch_state_dict(_jax_quantize(variables, bits), cfg)
    assert sorted(got) == sorted(want)
    leaf = "packed" if bits == 4 else "weight"
    assert got[f"model.layers.0.mlp.fc1.{leaf}"].dtype == torch.int8
    assert got["model.vision_tower.layers.0.blocks.0.mlp.fc1.weight"].dtype \
        == torch.float32
    for key, w in want.items():
        assert got[key].is_contiguous(), key  # K4 reads packed rows directly
        g = got[key].numpy()
        assert g.dtype == np.asarray(w).dtype, key
        assert g.tobytes() == np.ascontiguousarray(w).tobytes(), key


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_phi_matches_jax(tiny_variables, bits):
    cfg, variables = tiny_variables
    qvars = _jax_quantize(variables, bits)
    qcfg = cfg.replace(phi=dataclasses.replace(cfg.phi, quant_bits=bits))
    tcfg = tconfig.config_from_json(tconfig.config_to_json(qcfg))
    port = load_port(PSALM(tcfg, device="cpu"),
                     jax_to_torch_state_dict(qvars, qcfg))
    rng = np.random.default_rng(3)
    B, L = 2, 24
    embeds = rng.standard_normal((B, L, cfg.phi.hidden_size)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, 17:] = False
    want, _ = JPhiModel(qcfg.phi).apply(
        {"params": jax.tree.map(jnp.asarray, qvars["params"]["phi"]["model"])},
        jnp.asarray(embeds), jnp.asarray(mask))
    with torch.no_grad():
        got = port.model(torch.from_numpy(embeds), torch.from_numpy(mask))
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("shape,group", [((256, 128), 64), ((96, 40), 64)])
def test_native_kernel_packs_to_the_packed_bytes(shape, group):
    """JAX's unpacked int4 kernel, packed by ``from_jax``, is the packed
    storage's bytes: the same values, no loss."""
    k = _kernel(shape, 4)
    q4n, nscale = jquant.quantize_kernel_int4_native(k, group)
    packed, scale = jquant.quantize_kernel_int4(k, group)
    assert pack_int4(q4n).tobytes() == packed.tobytes()
    assert nscale.tobytes() == scale.tobytes()
    low, high = k4.unpack_int4(torch.from_numpy(pack_int4(q4n)))
    np.testing.assert_array_equal(torch.cat([low, high]).numpy(),
                                  np.asarray(q4n).astype(np.int8))


def test_quant4_native_matches_jax(layer_params, monkeypatch):
    """The port's "native" layer against JAX's ``Quant4Dense(storage=
    "native")`` (1e-5 of the output's magnitude), at every row count and
    on no path through K4 or its plain version."""
    k, bias = layer_params
    q4n, scale = jquant.quantize_kernel_int4_native(k, 64)
    params = {"params": {"kernel_q4n": q4n, "scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    jn = jquant.Quant4Dense(OUT_F, group=64, dtype=jnp.float32,
                            storage="native")
    td = quant.Quant4Dense(IN_F, OUT_F, storage="native")
    td.load_state_dict({"packed": torch.from_numpy(pack_int4(q4n)),
                        "scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})

    def refuse(*a, **kw):
        raise AssertionError("native storage reached int4_matvec")

    monkeypatch.setattr(quant, "int4_matvec", refuse)
    for x in _inputs(5):
        with torch.no_grad():
            got = td(torch.from_numpy(x)).numpy()
        assert got.shape == x.shape[:-1] + (OUT_F,)
        assert_close_rel(got, jn.apply(params, jnp.asarray(x)), rel=1e-5)


def test_native_quantized_phi_matches_jax(tiny_variables):
    """JAX's Phi quantized to native int4 storage, carried across by
    ``from_jax`` into a port model with ``quant_storage="native"``: the
    same bytes as the port's own quantizer, and the Phi's output within
    1e-4 of its magnitude."""
    cfg, variables = tiny_variables
    qvars = jquant.quantize_phi_int4(variables, storage="native")
    qcfg = cfg.replace(phi=dataclasses.replace(cfg.phi, quant_bits=4,
                                               quant_storage="native"))
    sd = jax_to_torch_state_dict(qvars, qcfg)
    own = quant.quantize_phi_int4(
        {k: torch.from_numpy(np.array(v)) for k, v in
         jax_to_torch_state_dict(variables, cfg).items()}, storage="native")
    assert sorted(own) == sorted(sd)
    for key, w in sd.items():
        assert own[key].numpy().tobytes() == np.ascontiguousarray(w).tobytes()
    tcfg = tconfig.config_from_json(tconfig.config_to_json(qcfg))
    port = load_port(PSALM(tcfg, device="cpu"), sd)
    layer = port.model.layers[0].mlp.fc1
    assert isinstance(layer, quant.Quant4Dense) and layer.storage == "native"
    rng = np.random.default_rng(6)
    embeds = rng.standard_normal((2, 20, cfg.phi.hidden_size)).astype(np.float32)
    mask = np.ones((2, 20), bool)
    mask[0, 13:] = False
    want, _ = JPhiModel(qcfg.phi).apply(
        {"params": jax.tree.map(jnp.asarray, qvars["params"]["phi"]["model"])},
        jnp.asarray(embeds), jnp.asarray(mask))
    with torch.no_grad():
        got = port.model(torch.from_numpy(embeds), torch.from_numpy(mask))
    assert_close_rel(got.numpy(), want)
