"""The port's serving stack on the CPU (tiny config, f32): request batching
over the port's Generator (the cases of tests/test_serve_batching.py), the
model worker through its real HTTP handler, and the builder against
psalm_tpu's ``load_pretrained_model`` on the same checkpoint directory
(Phi logits at 1e-4 of their magnitude, as in tests/test_torch_modules.py).
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_generation import chat_batch
from test_torch_modules import assert_close_rel, load_port, parity_state_dict

from psalm_tpu.config import tiny_test_config
from psalm_tpu.data.constants import IMAGE_TOKEN_INDEX
from psalm_tpu.models.builder import load_pretrained_model as jload
from psalm_tpu_torch.config import tiny_test_config as port_tiny_config
from psalm_tpu_torch.data.splicer import splice, stack_samples
from psalm_tpu_torch.data.tokenization import tokenize_special
from psalm_tpu_torch.models.builder import load_pretrained_model
from psalm_tpu_torch.models.generation import Generator
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.serve.batching import BatchedGenerator
from psalm_tpu_torch.serve.model_worker import ModelWorker, make_handler

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def gen():
    cfg = tiny_test_config()
    port = load_port(PSALM(cfg, device="cpu"), parity_state_dict(cfg, seed=5))
    return Generator(port, max_len=128, cache_dtype=torch.float32, device="cpu")


def _requests():
    b = chat_batch([[11, IMAGE_TOKEN_INDEX, 12, 13],
                    [7, IMAGE_TOKEN_INDEX, 12, 13, 14, 15]], 16, seed=6)
    return ({k: v[:1] for k, v in b.items()}, {k: v[1:] for k, v in b.items()})


def _run_pair(bg, jobs):
    results = {}

    def run(name, req, n, temp):
        results[name] = [int(t) for t in bg.submit(req, n, temperature=temp)]

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return results


def test_batched_matches_solo_and_groups(gen):
    r0, r1 = _requests()
    solo0 = gen.generate(r0, max_new_tokens=6)[0]
    solo1 = gen.generate(r1, max_new_tokens=6)[0]
    bg = BatchedGenerator(gen, eos_id=None, max_batch=2, window_s=0.5,
                          chunk_size=2)
    calls = []
    real_generate = gen.generate

    def counting_generate(*a, **k):
        calls.append(k.get("max_new_tokens"))
        return real_generate(*a, **k)

    gen.generate = counting_generate
    try:
        results = _run_pair(bg, [("a", r0, 6, 0.0), ("b", r1, 3, 0.0)])
    finally:
        gen.generate = real_generate
    assert calls == [6], f"expected ONE batched call of 6, got {calls}"
    np.testing.assert_array_equal(results["a"], solo0[:6])
    np.testing.assert_array_equal(results["b"], solo1[:3])


def test_per_sequence_temperature_row0_greedy(gen):
    r0, r1 = _requests()
    solo0 = gen.generate(r0, max_new_tokens=4)[0]
    bg = BatchedGenerator(gen, eos_id=None, max_batch=2, window_s=0.5,
                          chunk_size=2)
    results = _run_pair(bg, [("greedy", r0, 4, 0.0), ("sampled", r1, 4, 0.9)])
    np.testing.assert_array_equal(results["greedy"], solo0[:4])
    assert len(results["sampled"]) == 4


class StubTokenizer:
    """A deterministic character tokenizer: ids 100 + (code point % 300);
    each id decodes to "[id]"."""

    eos_token_id = None

    def encode(self, text, add_special_tokens=False):
        return [100 + ord(c) % 300 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"[{int(i)}]" for i in ids)


@pytest.fixture(scope="module")
def worker(gen):
    # a model built in memory, no controller: the worker's own constructor
    w = ModelWorker(None, None, None, "psalm-test", limit_concurrency=2,
                    image_size=64, decode_chunk=4, max_batch=2,
                    batch_window_ms=0.0, device="cpu", model=gen.model,
                    tokenizer=StubTokenizer())
    assert w.num_image_tokens == 1
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(w))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield w, f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _greedy_text(w, prompt, n):
    """What the worker should stream: the prompt plus the decoded greedy
    tokens of the worker's own splice."""
    ids = tokenize_special(prompt, w.tokenizer)
    pad_len = -(-(len(ids) + 1 + 8) // 64) * 64
    batch = stack_samples([splice(ids, None, num_image_tokens=1,
                                  num_seg_queries=1, pad_len=pad_len)])
    batch["images"] = np.zeros((1, 64, 64, 3), np.float32)
    toks = w.generator.generate(batch, max_new_tokens=n)[0]
    return prompt + w.tokenizer.decode(toks)


def test_worker_stream_and_status(worker):
    w, base = worker
    prompt = "<image>\nWhat is in the image?"
    raw = _post(base + "/worker_generate_stream",
                {"prompt": prompt, "max_new_tokens": 5, "temperature": 0.0})
    assert raw.endswith(b"\0")
    chunks = [json.loads(c) for c in raw.split(b"\0")[:-1]]
    assert len(chunks) == 5 and all(c["error_code"] == 0 for c in chunks)
    texts = [c["text"] for c in chunks]
    assert all(t.startswith(prompt) for t in texts)
    assert all(b.startswith(a) for a, b in zip(texts, texts[1:]))
    full = _greedy_text(w, prompt, 5)
    assert texts[-1] == full

    # stop truncates at the stop string and ends the stream
    stop = full[len(prompt):].split("]")[2] + "]"
    raw = _post(base + "/worker_generate_stream",
                {"prompt": prompt, "max_new_tokens": 5, "stop": stop})
    chunks = [json.loads(c) for c in raw.split(b"\0")[:-1]]
    assert chunks[-1]["text"] == full[:full.index(stop, len(prompt))]
    assert stop not in chunks[-1]["text"][len(prompt):]

    status = json.loads(_post(base + "/worker_get_status", {}))
    assert status == {"model_names": ["psalm-test"], "speed": 1,
                      "queue_length": 0}
    # /worker_segment answers (tests/test_torch_segment.py drives it); an
    # unknown route is a 404
    assert json.loads(_post(base + "/worker_segment", {"task": "panoptic"})) \
        == {"error_code": 1, "text": "segment requires 'image'"}
    with pytest.raises(urllib.error.HTTPError, match="404"):
        _post(base + "/worker_chat", {})


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    cfg = tiny_test_config()
    path = tmp_path_factory.mktemp("ckpt")
    torch.save({k: torch.from_numpy(v) for k, v in
                parity_state_dict(cfg, seed=7).items()},
               str(path / "pytorch_model.bin"))
    return cfg, str(path)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_builder_matches_jax_builder(checkpoint_dir, bits):
    cfg, path = checkpoint_dir
    kw = {"load_8bit": bits == 8, "load_4bit": bits == 4}
    tok, model, ctx = load_pretrained_model(path, cfg=port_tiny_config(),
                                           device="cpu", **kw)
    _, jmodel, jvars, jctx = jload(path, cfg=cfg, **kw)
    assert tok is None and ctx == jctx == cfg.phi.max_position_embeddings
    assert model.cfg.phi.quant_bits == bits
    layer = model.model.layers[0]
    if bits:
        leaf = layer.mlp.fc1.weight if bits == 8 else layer.mlp.fc1.packed
        assert leaf.dtype == torch.int8
        assert layer.self_attn.q_proj.scale.dtype == torch.float32
    assert model.lm_head.weight.dtype == torch.float32
    assert model.model.embed_tokens.weight.dtype == torch.float32
    rng = np.random.default_rng(8)
    embeds = rng.standard_normal((2, 12, cfg.phi.hidden_size)).astype(np.float32)
    want, _, _ = jmodel.apply(jax.tree.map(jnp.asarray, jvars),
                              jnp.asarray(embeds),
                              method=lambda m, e: m.phi(e))
    with torch.no_grad():
        got = model.lm_head(model.model(torch.from_numpy(embeds)))
    assert_close_rel(got.numpy(), want)


def test_builder_bf16_keeps_scales_and_statistics_f32(checkpoint_dir):
    cfg, path = checkpoint_dir
    _, model, _ = load_pretrained_model(path, cfg=port_tiny_config(),
                                        dtype=torch.bfloat16, load_4bit=True,
                                        device="cpu")
    sd = model.state_dict()
    kept = {k for k in sd if k.endswith((".scale", ".running_mean",
                                         ".running_var"))}
    assert any(".running_var" in k for k in kept)
    assert any(k.startswith("model.layers.") for k in kept)
    for k, v in sd.items():
        if k in kept:
            assert v.dtype == torch.float32, k
        elif k.endswith(".packed"):
            assert v.dtype == torch.int8, k
        else:
            assert v.dtype == torch.bfloat16, k
    with pytest.raises(ValueError, match="exclude"):
        load_pretrained_model(path, cfg=port_tiny_config(), load_8bit=True,
                              load_4bit=True, device="cpu")
