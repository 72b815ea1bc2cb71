"""The port's serving stack around the worker: the controller's flows (the
cases of tests/test_serve.py), the copies of psalm_tpu's JAX-free serving
modules held equal to the originals outside their import lines, a
controller + worker + web server run end to end in a subprocess that loads
nothing of psalm_tpu or JAX, and the chat CLI driven on stdin (tiny config,
on the CPU)."""

import ast
import inspect
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import psalm_tpu.serve.controller as jcontroller
import psalm_tpu.serve.moderation as jmoderation
import psalm_tpu.serve.register_worker as jregister_worker
import psalm_tpu.serve.test_message as jtest_message
import psalm_tpu.serve.web_server as jweb_server
import psalm_tpu_torch.serve.controller as tcontroller
import psalm_tpu_torch.serve.moderation as tmoderation
import psalm_tpu_torch.serve.register_worker as tregister_worker
import psalm_tpu_torch.serve.test_message as ttest_message
import psalm_tpu_torch.serve.web_server as tweb_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = {"controller": (jcontroller, tcontroller),
          "moderation": (jmoderation, tmoderation),
          "register_worker": (jregister_worker, tregister_worker),
          "test_message": (jtest_message, ttest_message),
          "web_server": (jweb_server, tweb_server)}
NO_JAX = ("bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax')\n"
          "       or m == 'psalm_tpu' or m.startswith('psalm_tpu.')]\n"
          "assert not bad, bad\n")


def _env():
    """The subprocesses' environment: the repo importable, no moderation
    key (the moderation hook then never leaves the machine), offline."""
    env = {k: v for k, v in os.environ.items() if k != "OPENAI_API_KEY"}
    env.update(PYTHONPATH=ROOT, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    return env


# -- the copies ----------------------------------------------------------------


class _ImportsAsJax(ast.NodeTransformer):
    """psalm_tpu_torch.* module names in import statements read as
    psalm_tpu.*: the one difference a copy may have."""

    def visit_ImportFrom(self, node):
        if node.module and node.module.startswith("psalm_tpu_torch"):
            node.module = "psalm_tpu" + node.module[len("psalm_tpu_torch"):]
        return node


@pytest.mark.parametrize("name", sorted(COPIES))
def test_copy_equals_original_outside_imports(name):
    original, copy = COPIES[name]
    want = ast.dump(ast.parse(inspect.getsource(original)))
    tree = _ImportsAsJax().visit(ast.parse(inspect.getsource(copy)))
    assert ast.dump(tree) == want
    for line in inspect.getsource(copy).splitlines():
        if "import" in line and "psalm_tpu" in line:
            assert "psalm_tpu_torch" in line, line


# -- the controller (tests/test_serve.py's flows) ------------------------------


def _post(url, payload, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


class StubWorkerHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        if self.path == "/worker_generate_stream":
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            for piece in ["hel", "hello wor", "hello world"]:
                self.wfile.write(json.dumps(
                    {"text": piece, "error_code": 0}).encode() + b"\0")


@pytest.fixture()
def servers():
    controller = tcontroller.Controller()
    csrv = ThreadingHTTPServer(("127.0.0.1", 0),
                               tcontroller.make_handler(controller))
    wsrv = ThreadingHTTPServer(("127.0.0.1", 0), StubWorkerHandler)
    for s in (csrv, wsrv):
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield (controller, f"http://127.0.0.1:{csrv.server_port}",
           f"http://127.0.0.1:{wsrv.server_port}")
    csrv.shutdown()
    wsrv.shutdown()


def test_register_list_dispatch_stream(servers):
    controller, curl, wurl = servers
    out = json.loads(_post(curl + "/register_worker", {
        "worker_name": wurl, "check_heart_beat": True,
        "worker_status": {"model_names": ["psalm"], "speed": 1,
                          "queue_length": 0}}))
    assert out["exist"]
    assert json.loads(_post(curl + "/list_models", {}))["models"] == ["psalm"]
    addr = json.loads(_post(curl + "/get_worker_address",
                            {"model": "psalm"}))["address"]
    assert addr == wurl
    raw = _post(curl + "/worker_generate_stream",
                {"model": "psalm", "prompt": "hi"})
    chunks = [json.loads(c) for c in raw.split(b"\0") if c]
    assert chunks[-1]["text"] == "hello world"
    # heartbeat, then expiry of a stale worker
    assert json.loads(_post(curl + "/receive_heart_beat", {
        "worker_name": wurl, "queue_length": 3}))["exist"]
    controller.workers[wurl].last_heart_beat = time.time() - 1000
    assert json.loads(_post(curl + "/list_models", {}))["models"] == []


def test_dispatch_no_worker(servers):
    _, curl, _ = servers
    raw = json.loads(_post(curl + "/worker_generate_stream",
                           {"model": "nope", "prompt": "hi"}))
    assert raw["error_code"] == 2


def test_shortest_queue_and_lottery_dispatch():
    c = tcontroller.Controller()
    for name, q, speed in (("a", 4, 1), ("b", 1, 1), ("c", 3, 4)):
        c.register_worker(name, False, {"model_names": ["m"], "speed": speed,
                                        "queue_length": q})
    # the shortest queue over speed, each pick queueing one more: c (0.75),
    # b (1, before c's 1.0), c (1.0 against b's 2)
    assert [c.get_worker_address("m") for _ in range(3)] == ["c", "b", "c"]
    c.dispatch_method = "lottery"
    np.random.seed(0)
    assert {c.get_worker_address("m") for _ in range(50)} <= {"a", "b", "c"}
    assert c.get_worker_address("other") == ""
    assert not c.receive_heart_beat("nobody", 0)


# -- controller + worker + web server, end to end ------------------------------

E2E = r"""
import base64, io, json, sys, threading, urllib.request, contextlib
from http.server import ThreadingHTTPServer
import numpy as np, torch
from PIL import Image
from chip_smoke import StubTokenizer
from psalm_tpu_torch import tiny_test_config
from psalm_tpu_torch.data import coco_rle
from psalm_tpu_torch.models.psalm import PSALM, init_weights_
from psalm_tpu_torch.serve import (controller, model_worker, register_worker,
                                   test_message, web_server)

def serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"

def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()

_, curl = serve(controller.make_handler(controller.Controller()))
wsrv, wurl = serve(None)  # its handler once the worker exists
cfg = tiny_test_config()
model = init_weights_(PSALM(cfg, device="cpu"), torch.Generator().manual_seed(0))
worker = model_worker.ModelWorker(curl, wurl, None, "psalm-e2e",
                                  image_size=cfg.image_size, decode_chunk=2,
                                  device="cpu", model=model,
                                  tokenizer=StubTokenizer())
wsrv.RequestHandlerClass = model_worker.make_handler(worker)
_, web = serve(web_server.make_handler(curl, moderate=True))

assert json.loads(post(curl + "/list_models", {}))["models"] == ["psalm-e2e"]
addr = json.loads(post(curl + "/get_worker_address",
                       {"model": "psalm-e2e"}))["address"]
assert addr == wurl, addr
buf = io.BytesIO()
image = np.random.default_rng(0).integers(0, 256, (40, 70, 3), np.uint8)
Image.fromarray(image).save(buf, format="JPEG")
seg = json.loads(post(addr + "/worker_segment", {
    "image": base64.b64encode(buf.getvalue()).decode(), "task": "panoptic"}))
assert seg["error_code"] == 0 and (seg["height"], seg["width"]) == (40, 70)
for s in seg["segments"]:
    assert coco_rle.decode(s["rle"]).shape == (40, 70)
with urllib.request.urlopen(web, timeout=60) as r:
    assert b"<textarea" in r.read()
prompt = "What is in the image?"
raw = post(web + "/generate", {"model": "psalm-e2e", "prompt": prompt,
                               "temperature": 0.0, "max_new_tokens": 5})
chunks = [json.loads(c) for c in raw.split(b"\0") if c]
assert len(chunks) == 5 and chunks[-1]["error_code"] == 0, chunks
assert chunks[-1]["text"].startswith(prompt)
assert chunks[-1]["text"][len(prompt):].count("[") == 5
out = io.StringIO()
with contextlib.redirect_stdout(out):
    sys.argv = ["register_worker", "--controller-address", curl,
                "--worker-name", "http://127.0.0.1:1"]
    register_worker.main()
    sys.argv = ["test_message", "--controller-address", curl,
                "--model-name", "psalm-e2e", "--message", "Hi",
                "--max-new-tokens", "3"]
    test_message.main()
lines = out.getvalue().splitlines()
assert lines[0] == '{"exist": true}' and lines[1] == "worker address: " + wurl
assert len(lines) == 5 and lines[-1].startswith("Hi"), lines
""" + NO_JAX + "print('E2E OK', len(seg['segments']))\n"


def test_controller_worker_web_server_end_to_end():
    proc = subprocess.run([sys.executable, "-c", E2E], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "E2E OK" in proc.stdout


# -- the chat CLI on stdin -----------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A checkpoint directory: random tiny weights, the config, an image and
    a word-level HF tokenizer (the eos token is Phi's separator)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    from PIL import Image
    from psalm_tpu_torch.config import config_to_json, tiny_test_config
    from psalm_tpu_torch.models.psalm import PSALM, init_weights_
    path = tmp_path_factory.mktemp("chat")
    words = ("[UNK] <|endoftext|> hello there what is in the image ? a an "
             "USER: ASSISTANT: You are helpful language and vision "
             "assistant. able to understand visual content that user "
             "provides, assist with variety of tasks using natural "
             "language.").split()
    vocab = {w: i for i, w in enumerate(dict.fromkeys(words))}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                            eos_token="<|endoftext|>").save_pretrained(path)
    cfg = tiny_test_config()
    model = init_weights_(PSALM(cfg, device="cpu"),
                          torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), path / "pytorch_model.bin")
    (path / "psalm_tpu_config.json").write_text(config_to_json(cfg))
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (50, 80, 3), np.uint8)).save(path / "image.png")
    return str(path)


CHAT = ["hello there", "what is in the image ?"]


def _argv(path):
    return ["--model-path", path, "--image-file", os.path.join(path,
                                                                "image.png"),
            "--temperature", "0", "--max-new-tokens", "4", "--device", "cpu"]


def test_chat_cli_on_stdin(checkpoint, monkeypatch, capsys):
    import io
    from psalm_tpu_torch.data.conversation import conv_llava_phi
    from psalm_tpu_torch.data.mappers import ImageMapper
    from psalm_tpu_torch.data.splicer import splice, stack_samples
    from psalm_tpu_torch.data.tokenization import tokenize_special
    from psalm_tpu_torch.models.builder import load_pretrained_model
    from psalm_tpu_torch.models.generation import Generator
    from psalm_tpu_torch.serve import cli
    from PIL import Image

    code = ("import runpy, sys\n"
            f"sys.argv = ['cli'] + {_argv(checkpoint)!r}\n"
            "runpy.run_module('psalm_tpu_torch.serve.cli', "
            "run_name='__main__')\n" + NO_JAX)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          input="\n".join(CHAT) + "\n\n", capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    answers = [line for line in proc.stdout.split("USER: ") if line]
    assert len(answers) == 2 and all(a.startswith("ASSISTANT: ")
                                     for a in answers), proc.stdout

    # the same conversation in this process gives the same answers
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(CHAT) + "\n"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    tok, model, ctx = load_pretrained_model(checkpoint, device="cpu")
    args = cli.parse_args(_argv(checkpoint))
    assert cli.parse_args(["--model-path", "x"]).device == "cuda"
    cli.chat(args, tok, model, ctx)
    assert capsys.readouterr().out == proc.stdout

    # the first answer is the greedy generation of the first turn's prompt
    conv = conv_llava_phi.copy()
    conv.append_message(conv.roles[0], "<image>\n" + CHAT[0])
    conv.append_message(conv.roles[1], "")
    ids = tokenize_special(conv.get_prompt(), tok)
    mapper = ImageMapper(model.cfg.image_size)
    image = np.asarray(Image.open(os.path.join(checkpoint, "image.png"))
                       .convert("RGB"))
    batch = stack_samples([splice(ids, None, num_image_tokens=1,
                                  num_seg_queries=1, pad_len=len(ids) + 9)])
    batch["images"] = mapper.transform_image(image).image[None]
    toks = Generator(model, max_len=ctx, device="cpu").generate(
        batch, max_new_tokens=4, temperature=0.0, eos_id=tok.eos_token_id)
    want = tok.decode(toks[0].tolist(), skip_special_tokens=True)
    assert answers[0].rstrip("\n") == "ASSISTANT: " + want
