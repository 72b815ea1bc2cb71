"""The port's weight tools against psalm_tpu's, exactly: deltas, their
application and consolidation on two random tiny models (one with a grown
vocabulary), and the legacy vision-tokenizer set-up, JAX's on its variables
and the port's on the state dict that ``from_jax`` makes of them."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_modules import parity_state_dict

from psalm_tpu.checkpoint import weight_tools as jtools
from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu_torch.checkpoint import weight_tools as ttools
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict

GROW = 3  # rows the target's vocabulary has beyond the base's


def _variables(cfg, seed, grow=0):
    sd = parity_state_dict(cfg, seed=seed)
    if grow:
        rng = np.random.default_rng(seed)
        for k in ("model.embed_tokens.weight", "lm_head.weight"):
            sd[k] = np.concatenate([sd[k], rng.standard_normal(
                (grow, sd[k].shape[1])).astype(np.float32)])
    # jax arrays, as JAX's tools are handed them (C-ordered on the host)
    return jax.tree.map(jnp.asarray, convert_psalm_checkpoint(sd, cfg))


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    base, target = _variables(cfg, 2), _variables(cfg, 3, grow=GROW)
    return cfg, base, target


def _sd(variables, cfg):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_to_torch_state_dict(variables, cfg).items()}


def _assert_equal(got, want_variables, cfg):
    want = jax_to_torch_state_dict(want_variables, cfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, torch.Tensor), k
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, k
        assert g.numpy().tobytes() == np.ascontiguousarray(w).tobytes(), k


def test_make_and_apply_delta_match_jax(models):
    cfg, base, target = models
    delta = ttools.make_delta(_sd(base, cfg), _sd(target, cfg))
    jdelta = jtools.make_delta(base, target)
    _assert_equal(delta, jdelta, cfg)
    # the grown vocabulary's tables are kept raw
    assert torch.equal(delta["model.embed_tokens.weight"],
                       _sd(target, cfg)["model.embed_tokens.weight"])
    _assert_equal(ttools.apply_delta(_sd(base, cfg), delta),
                  jtools.apply_delta(base, jdelta), cfg)
    with pytest.raises(ValueError, match="differ in keys"):
        ttools.make_delta({"a": torch.zeros(1)}, {"b": torch.zeros(1)})


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_consolidate_matches_jax(models, dtype):
    cfg, _, target = models
    got = ttools.consolidate(_sd(target, cfg), getattr(torch, dtype))
    _assert_equal(got, jtools.consolidate(target, getattr(np, dtype)), cfg)


class _Tokenizer:
    """add_tokens and len, as a HF tokenizer has them."""

    def __init__(self, n):
        self.tokens = [f"t{i}" for i in range(n)]

    def add_tokens(self, tokens, special_tokens=False):
        new = [t for t in tokens if t not in self.tokens]
        self.tokens += new
        return len(new)

    def __len__(self):
        return len(self.tokens)


CASES = {  # (patch token, start/end, adapter rows: 0 none, 2, or all)
    "none": (False, False, 0),
    "patch": (True, False, 0),
    "start_end": (False, True, 0),
    "both_full_adapter": (True, True, -1),
    "start_end_two_rows": (False, True, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("vocab_extra", [0, 4])
def test_initialize_vision_tokenizer_matches_jax(models, case, vocab_extra):
    cfg, base, _ = models
    patch, start_end, rows = CASES[case]
    V = cfg.phi.vocab_size + vocab_extra
    grow = V + patch + 2 * start_end - cfg.phi.vocab_size
    adapter = None
    if rows:
        rng = np.random.default_rng(7)
        shape = ((cfg.phi.vocab_size + grow) if rows < 0 else rows,
                 cfg.phi.hidden_size)
        adapter = {"model.embed_tokens.weight":
                   rng.standard_normal(shape).astype(np.float32)}
    sd = _sd(base, cfg)
    before = {k: v.clone() for k, v in sd.items()}
    got = ttools.initialize_vision_tokenizer(
        sd, _Tokenizer(V), patch, start_end,
        None if adapter is None else {k: torch.from_numpy(v)
                                      for k, v in adapter.items()})
    want = jtools.initialize_vision_tokenizer(base, _Tokenizer(V), patch,
                                              start_end, adapter)
    _assert_equal(got, want, cfg)
    assert got["model.embed_tokens.weight"].shape[0] == \
        cfg.phi.vocab_size + (grow if patch or start_end else 0)
    for k, v in sd.items():  # the input is left as it was
        assert torch.equal(v, before[k]), k


def test_initialize_vision_tokenizer_refuses_a_bad_adapter(models):
    cfg, base, _ = models
    bad = {"model.embed_tokens.weight":
           np.zeros((5, cfg.phi.hidden_size), np.float32)}
    V = cfg.phi.vocab_size
    with pytest.raises(ValueError, match="Unexpected embed_tokens shape"):
        jtools.initialize_vision_tokenizer(base, _Tokenizer(V), False, True,
                                           bad)
    with pytest.raises(ValueError, match="Unexpected embed_tokens shape"):
        ttools.initialize_vision_tokenizer(_sd(base, cfg), _Tokenizer(V),
                                           False, True, bad)
