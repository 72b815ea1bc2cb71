"""KV-cache generation of the port against psalm_tpu on the CPU (tiny
config, f32, cache in f32).

* Unpadded prompts, where psalm_tpu's cache is right: the port's prefill and
  decode logits equal ``PhiForCausalLM`` with caches, and its ``Generator``'s
  greedy tokens equal JAX's ``Generator``'s.
* Right-padded prompts of different valid lengths in one batch: the port's
  step logits and greedy tokens equal a teacher-forced JAX full-sequence
  forward over each row's prompt plus the generated tokens, with no cache.
  (psalm_tpu's cache writes every row at the padded length and is wrong
  here; ROADMAP Queue 3.)
* EOS, stream and sampling semantics of ``generate``.

Tolerance: logits 1e-4 of their magnitude, as Phi in
tests/test_torch_modules.py. Greedy tokens are compared exactly up to the
first step whose top-2 logit margin is below 1e-4: there, summation order
may break the tie either way, and the test says so and stops comparing.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_modules import assert_close_rel, load_port, parity_state_dict

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config
from psalm_tpu.data.constants import IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from psalm_tpu.models.generation import Generator as JGenerator
from psalm_tpu.models.phi import PhiForCausalLM as JPhiForCausalLM
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.data.splicer import splice, stack_samples
from psalm_tpu_torch.models.generation import Generator
from psalm_tpu_torch.models.psalm import PSALM

torch.backends.cuda.matmul.allow_tf32 = False

MARGIN = 1e-4
NEW = 6


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    variables = jax.tree.map(jnp.asarray, convert_psalm_checkpoint(
        parity_state_dict(cfg, seed=4), cfg))
    port = load_port(PSALM(cfg, device="cpu"),
                     jax_to_torch_state_dict(variables, cfg))
    return cfg, variables, port


def chat_batch(prompts, pad_len, seed=0, image_size=64):
    """Spliced chat prompts (one image token, one seg query) and images."""
    batch = stack_samples([splice(p, None, num_image_tokens=1,
                                  num_seg_queries=1, pad_len=pad_len)
                           for p in prompts])
    rng = np.random.default_rng(seed)
    batch["images"] = rng.standard_normal(
        (len(prompts), image_size, image_size, 3)).astype(np.float32)
    return batch


def greedy_steps(gen, batch, steps):
    """Port greedy decode through prefill/decode: (tokens [B, T], step
    logits [T, B, V] as float64)."""
    logits, cache = gen.prefill(batch)
    toks, seen = [], []
    for _ in range(steps):
        seen.append(logits.double().numpy())
        tok = logits.argmax(-1)
        toks.append(tok.numpy())
        logits = gen.decode(tok, cache)
    return np.stack(toks, 1), np.stack(seen)


def decided_steps(step_logits):
    """Per row, the number of leading steps whose top-2 margin exceeds
    MARGIN."""
    s = np.sort(step_logits, -1)
    ok = (s[..., -1] - s[..., -2]) > MARGIN  # [T, B]
    n = [int(np.argmin(np.append(ok[:, b], False))) for b in range(ok.shape[1])]
    if min(n) < ok.shape[0]:
        warnings.warn(f"near-tie greedy step: comparing only the first {n} "
                      "steps of each row")
    return n


def test_cache_logits_match_jax_phi(models):
    cfg, variables, port = models
    B, L, S = 2, 8, 16
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((B, L, cfg.phi.hidden_size)).astype(np.float32)
    jphi = JPhiForCausalLM(cfg.phi)
    params = {"params": variables["params"]["phi"]}
    jcache = jphi.apply(params, B, S, method=lambda m, b, s: m.model.init_cache(
        b, s, jnp.float32))
    jlogits, _, jcache = jphi.apply(
        params, jnp.asarray(embeds),
        positions=jnp.broadcast_to(jnp.arange(L), (B, L)), caches=jcache)
    cache = port.model.init_cache(B, S, torch.float32)
    with torch.no_grad():
        hidden = port.model(torch.from_numpy(embeds), cache=cache)
        assert_close_rel(port.lm_head(hidden).numpy(), jlogits)
        for step, tok in enumerate(([3, 7], [400, 9], [12, 12])):
            emb = jphi.apply(params, jnp.asarray(tok)[:, None],
                             method=lambda m, t: m.embed(t))
            jlogits, _, jcache = jphi.apply(
                params, emb, positions=jnp.full((B, 1), L + step), caches=jcache)
            t = torch.tensor(tok)
            hidden = port.model(port.model.embed(t[:, None]), cache=cache)
            assert_close_rel(port.lm_head(hidden).numpy(), jlogits)
    assert cache.span == L + 3 and cache.pos.tolist() == [L + 3] * B


@pytest.mark.parametrize("chunk", [1, 4])
def test_generator_matches_jax_unpadded(models, chunk):
    cfg, variables, port = models
    prompts = [[11, IMAGE_TOKEN_INDEX, 12, 13, SEG_TOKEN_INDEX, 14],
               [21, IMAGE_TOKEN_INDEX, 22, 23, SEG_TOKEN_INDEX, 24]]
    L = 6  # no padding: each row holds 6 valid tokens
    batch = chat_batch(prompts, L, seed=1)
    assert batch["attention_mask"].all()
    want = JGenerator(JPSALM(cfg), variables, max_len=L + 8,
                      cache_dtype=jnp.float32).generate(
        batch, max_new_tokens=NEW, chunk_size=chunk)
    gen = Generator(port, max_len=L + 8, cache_dtype=torch.float32,
                    device="cpu")
    got = gen.generate(batch, max_new_tokens=NEW, chunk_size=chunk)
    assert got.shape == want.shape == (2, NEW)
    toks, step_logits = greedy_steps(gen, batch, NEW)
    np.testing.assert_array_equal(toks, got)
    for b, n in enumerate(decided_steps(step_logits)):
        np.testing.assert_array_equal(got[b, :n], want[b, :n])


def _jax_teacher_forced_logits(cfg, variables, batch, b, toks):
    """JAX full-sequence logits over row b's valid prompt and ``toks``."""
    model = JPSALM(cfg)
    n = int(batch["attention_mask"][b].sum())
    row = {k: jnp.asarray(np.asarray(batch[k])[b:b + 1])
           for k in ("tok_ids", "src_type", "src_idx", "images")}
    image_tokens = model.apply(variables, row["images"],
                               method=lambda m, im: m.encode_images(im)[1])
    seq = model.apply(variables, row["tok_ids"], row["src_type"],
                      row["src_idx"], image_tokens,
                      method=lambda m, t, st, si, it: m.assemble_embeddings(
                          t, st, si, it))
    emb = model.apply(variables, jnp.asarray(toks)[None],
                      method=lambda m, t: m.phi.embed(t))
    full = jnp.concatenate([seq[:, :n], emb], axis=1)
    logits, _, _ = model.apply(variables, full,
                               method=lambda m, e: m.phi(e))
    return np.asarray(logits[0, n - 1:], np.float64)  # [len(toks) + 1, V]


def test_padded_mixed_lengths_match_teacher_forced_jax(models):
    cfg, variables, port = models
    prompts = [[11, IMAGE_TOKEN_INDEX, 12, 13],                       # n = 4
               [21, IMAGE_TOKEN_INDEX, 22, 23, 24, 25, 26, 27, 28]]   # n = 9
    L = 16
    batch = chat_batch(prompts, L, seed=2)
    assert batch["attention_mask"].sum(1).tolist() == [4, 9]
    gen = Generator(port, max_len=L + NEW, cache_dtype=torch.float32,
                    device="cpu")
    toks, step_logits = greedy_steps(gen, batch, NEW)
    np.testing.assert_array_equal(
        gen.generate(batch, max_new_tokens=NEW, chunk_size=4), toks)
    for b, n in enumerate(decided_steps(step_logits)):
        want = _jax_teacher_forced_logits(cfg, variables, batch, b,
                                          toks[b, :NEW - 1])
        assert_close_rel(step_logits[:, b], want)
        np.testing.assert_array_equal(toks[b, :n], want.argmax(-1)[:n])


@pytest.fixture(scope="module")
def eos_setup(models):
    cfg, variables, port = models
    prompts = [[11, IMAGE_TOKEN_INDEX, 12, 13, 14],
               [31, IMAGE_TOKEN_INDEX, 32]]
    batch = chat_batch(prompts, 8, seed=3)
    gen = Generator(port, max_len=8 + 16, cache_dtype=torch.float32,
                    device="cpu")
    return gen, batch


def test_eos_and_stream(eos_setup):
    """As tests/test_train_and_generate.py::test_generation_batched_eos_handling:
    tokens after a row's EOS are eos_id, the other row keeps decoding, and
    the stream sees every emitted column."""
    gen, batch = eos_setup
    free = gen.generate(batch, max_new_tokens=NEW, chunk_size=2)
    eos_id = None
    for j in range(NEW):
        tok0 = int(free[0, j])
        if tok0 not in [int(t) for t in free[1, : j + 1]]:
            eos_id = tok0
            break
    if eos_id is None:
        eos_id = int(free[0, 0])
    seen = []
    toks = gen.generate(batch, max_new_tokens=NEW, eos_id=eos_id,
                        stream=lambda t: seen.append(np.array(t)),
                        chunk_size=2)
    B, T = toks.shape
    assert B == 2 and T <= NEW
    assert len(seen) == T
    np.testing.assert_array_equal(np.stack(seen, 1), toks)
    for b in range(B):
        row = toks[b]
        hit = np.where(row == eos_id)[0]
        upto = hit[0] if hit.size else T
        if hit.size:
            assert (row[hit[0]:] == eos_id).all()
        np.testing.assert_array_equal(row[:upto], free[b, :upto])
    # every row hits EOS at once: the loop stops there
    first = int(free[0, 0])
    assert gen.generate({k: v[:1] for k, v in batch.items()},
                        max_new_tokens=NEW, eos_id=first).shape == (1, 1)


def test_sampling_seeded_and_greedy_rows(eos_setup):
    gen, batch = eos_setup
    temps = np.array([0.0, 0.9], np.float32)

    def sampled(seed):
        return gen.generate(batch, max_new_tokens=NEW, temperature=temps,
                            generator=torch.Generator().manual_seed(seed),
                            chunk_size=4)

    a, b = sampled(5), sampled(5)
    np.testing.assert_array_equal(a, b)
    solo = gen.generate({k: v[:1] for k, v in batch.items()},
                        max_new_tokens=NEW)
    np.testing.assert_array_equal(a[0], solo[0])
    hot = gen.generate(batch, max_new_tokens=NEW, temperature=50.0,
                       generator=torch.Generator().manual_seed(6))
    assert not np.array_equal(hot, gen.generate(batch, max_new_tokens=NEW))


def test_cache_limits_raise(eos_setup):
    gen, batch = eos_setup
    with pytest.raises(ValueError, match="exceed the KV cache"):
        gen.generate(batch, max_new_tokens=gen.max_len)
    assert gen.generate(batch, max_new_tokens=0).shape == (2, 0)
