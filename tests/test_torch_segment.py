"""The port's segmentation service against psalm_tpu's, and the worker's
``/worker_segment`` route over HTTP (tiny config, f32, on the CPU).

``SegmentService`` of both packages runs the panoptic, semantic and
referring tasks on the same images with one random state dict (the class
head scaled by 3, as in ``test_torch_eval_clis.py``, so that panoptic
segments pass the 0.8 threshold), JAX's through
``convert_psalm_checkpoint``, the port's through ``from_jax``, both with
``chip_smoke.WordTokenizer``. Every RLE is decoded and compared pixel by
pixel under the tie rule of ``ROADMAP.md`` Queue 3: a pixel may differ only
where JAX's decision has a margin at or below 1e-3 (its model outputs are
captured inside its jitted runner); scores agree to 1e-3, and where two
masks are equal their RLE ``counts`` strings are equal byte for byte.
"""

import base64
import io
import json
import re
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from chip_smoke import WordTokenizer
from test_torch_eval_clis import (MARGIN, _Capture, _mask_decided,
                                  _panoptic_decided, _probs, _record,
                                  _restored, _top2, _Tally)
from test_torch_modules import load_port, parity_state_dict

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import tiny_test_config as jtiny_test_config
from psalm_tpu.data import coco_rle as jcoco_rle
from psalm_tpu.eval import runner as jrunner
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu.serve import model_worker as jworker
from psalm_tpu.serve import segmentation as jseg
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.config import tiny_test_config
from psalm_tpu_torch.data import coco_rle
from psalm_tpu_torch.eval import geometry
from psalm_tpu_torch.eval import runner as trunner
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.ops.sampling import resize_bilinear
from psalm_tpu_torch.serve import model_worker as tworker
from psalm_tpu_torch.serve import segmentation as tseg

S = 64  # the tiny config's image size
MAX_LENGTH = 512  # the tiny Phi's positions
EXPRESSION = "the person on the left holding a red umbrella"
HW = {"nonsquare": (97, 131), "square": (48, 56)}


@pytest.fixture(scope="module")
def services():
    jcfg = jtiny_test_config()
    sd = parity_state_dict(jcfg, seed=3)
    for k in [k for k in sd if "CLASS_proj.layers.1." in k]:
        sd[k] = sd[k] * 3.0
    variables = jax.tree.map(jnp.asarray, convert_psalm_checkpoint(sd, jcfg))
    names = [f"class {i}" for i in range(jcfg.num_classes)] + ["background"]
    is_thing = [True, True, True, False, False]
    cap = _Capture(JPSALM(jcfg))
    tok = WordTokenizer(jcfg.phi.vocab_size)
    jservice = jseg.SegmentService(cap, variables, tok, jcfg,
                                   class_names=names, is_thing=is_thing,
                                   max_length=MAX_LENGTH)
    cfg = tiny_test_config()
    model = load_port(PSALM(cfg, device="cpu"),
                      jax_to_torch_state_dict(variables, jcfg))
    tservice = tseg.SegmentService(model, tok, cfg, class_names=names,
                                   is_thing=is_thing, max_length=MAX_LENGTH)
    return jservice, cap, tservice


def _image(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)


def _run(services, monkeypatch, task, image):
    """Both services on ``image``: (JAX's reply, its runner record with the
    model outputs, the port's reply, its runner record)."""
    jservice, cap, tservice = services
    jrec, trec = [], []
    _record(monkeypatch, jrunner.EvalRunner, jrec)
    _record(monkeypatch, trunner.EvalRunner, trec)
    cap.outs.clear()
    kw = {"expression": EXPRESSION} if task == "referring" else {}
    want = jservice.segment(image, task, **kw)
    jax.effects_barrier()
    got = tservice.segment(image, task, **kw)
    assert len(jrec) == len(trec) == len(cap.outs) == 1
    jrec[0]["model"] = cap.outs[0]
    json.dumps(got)  # the reply is what the worker sends as JSON
    return want, jrec[0], got, trec[0]


def _decode(rle, hw):
    m = coco_rle.decode(rle)
    assert m.shape == hw and isinstance(rle["counts"], str)
    return m.astype(bool)


def _counts_equal_where_masks_are(got_rle, want_rle, hw):
    if np.array_equal(_decode(got_rle, hw), _decode(want_rle, hw)):
        assert got_rle == want_rle


def _segment_keys_of_reply(reply, rec, hw):
    """A panoptic reply's segments by identity (a thing by its query, a
    stuff segment by Q + its class), read from its RLEs; the runner's map
    must be what the RLEs say."""
    seg = rec["out"]["segments"]
    ids, valid = seg["id"][0], seg["valid"][0]
    Q = len(ids)
    keys = np.full(hw, -1, np.int64)
    pan = np.zeros(hw, np.int64)
    for s in reply["segments"]:
        m = _decode(s["rle"], hw)
        assert m.any() and not (pan[m] != 0).any()
        pan[m] = s["id"]
        (q,) = np.flatnonzero(valid & (ids == s["id"]))[:1]
        keys[m] = q if s["isthing"] else Q + s["category_id"]
    np.testing.assert_array_equal(pan, rec["out"]["panoptic_seg"][0])
    return keys


@pytest.mark.parametrize("geometry_name", sorted(HW))
def test_panoptic_matches_jax(services, monkeypatch, geometry_name):
    hw = HW[geometry_name]
    want, jrec, got, trec = _run(services, monkeypatch, "panoptic",
                                 _image(hw, 1))
    assert (got["height"], got["width"]) == (want["height"], want["width"]) \
        == hw
    assert want["segments"], "JAX's reply holds no segment"
    ids = [s["id"] for s in got["segments"]]
    assert len(set(ids)) == len(ids)
    pixel_ok, _, tied = _panoptic_decided(
        jrec["model"]["pred_class_name_logits"][0], _restored(jrec))
    tally = _Tally()
    tally.pixels(_segment_keys_of_reply(got, trec, hw),
                 _segment_keys_of_reply(want, jrec, hw), pixel_ok,
                 "panoptic segments")
    if not tied.any():
        strip = [{k: v for k, v in s.items() if k != "rle"}
                 for s in got["segments"]]
        assert strip == [{k: v for k, v in s.items() if k != "rle"}
                         for s in want["segments"]]
    for g, w in zip(got["segments"], want["segments"]):
        if g["id"] == w["id"]:
            _counts_equal_where_masks_are(g["rle"], w["rle"], hw)


@pytest.mark.parametrize("geometry_name", sorted(HW))
def test_semantic_matches_jax(services, monkeypatch, geometry_name):
    hw = HW[geometry_name]
    want, jrec, got, trec = _run(services, monkeypatch, "semantic",
                                 _image(hw, 2))
    H, W = hw
    pm = torch.from_numpy(jrec["model"]["pred_masks"][0].astype(np.float32))
    up = resize_bilinear(pm[..., None], (S, S))[..., 0]
    sig = geometry.resize_to_original(torch.sigmoid(up), jrec["content"],
                                      jrec["original"], jrec["bucket"])[
                                          :, :H, :W].numpy()
    probs = _probs(jrec["model"]["pred_class_name_logits"][0])[:, :-1]
    decided = _top2(np.einsum("qk,qhw->khw", probs, sig), 0) > MARGIN
    maps = []
    for reply, rec in ((got, trec), (want, jrec)):
        m = np.full(hw, -1)
        for c in reply["classes"]:
            mask = _decode(c["rle"], hw)
            assert not (m[mask] != -1).any()
            m[mask] = c["category_id"]
        sem = rec["out"]["sem_seg"][0]
        np.testing.assert_array_equal(np.where(m >= 0, m, sem), sem)
        maps.append(m)
    _Tally().pixels(maps[0], maps[1], decided, "semantic map")
    by_class = {c["category_id"]: c["rle"] for c in want["classes"]}
    for c in got["classes"]:
        if c["category_id"] in by_class:
            _counts_equal_where_masks_are(c["rle"], by_class[c["category_id"]],
                                          hw)


@pytest.mark.parametrize("geometry_name", sorted(HW))
def test_referring_matches_jax(services, monkeypatch, geometry_name):
    hw = HW[geometry_name]
    want, jrec, got, trec = _run(services, monkeypatch, "referring",
                                 _image(hw, 3))
    jr, tr = jrec["out"]["referring"], trec["out"]["referring"]
    js = jr["scores"][0]
    top_j, top_t = int(np.argmax(js)), int(np.argmax(tr["scores"][0]))
    assert want["score"] == float(js[top_j])
    assert got["score"] == float(tr["scores"][0][top_t])
    tally = _Tally()
    if tally.choice(int(tr["query"][0][top_t]), int(jr["query"][0][top_j]),
                    _top2(js, 0), "referring query"):
        assert abs(got["score"] - want["score"]) <= MARGIN
        q = int(jr["query"][0][top_j])
        tally.pixels(_decode(got["rle"], hw), _decode(want["rle"], hw),
                     _mask_decided(_restored(jrec)[q]), "referring mask")
        _counts_equal_where_masks_are(got["rle"], want["rle"], hw)


def test_rle_strings_equal_jax_codec():
    """``_jsonable_rle`` of the port's codec gives JAX's strings byte for
    byte (masks of every run shape, the empty and the full one)."""
    rng = np.random.default_rng(0)
    masks = [np.zeros((97, 131), bool), np.ones((48, 56), bool)]
    masks += [rng.random((97, 131)) < p for p in (0.01, 0.5, 0.99)]
    blob = np.zeros((480, 640), bool)
    blob[100:300, 50:600] = True
    masks.append(blob)
    for m in masks:
        got = tseg._jsonable_rle(coco_rle.encode(m))
        want = jseg._jsonable_rle(jcoco_rle.encode(m))
        assert got == want
        assert json.loads(json.dumps(got)) == got


def test_segment_errors_match_jax(services):
    jservice, _, tservice = services
    image = _image((8, 8), 0)
    for svc in (tservice, jservice):
        with pytest.raises(ValueError, match="unknown segmentation task"):
            svc.segment(image, "detection")
        with pytest.raises(ValueError, match="requires 'expression'"):
            svc.segment(image, "referring")


# -- the worker's route over HTTP ------------------------------------------


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _png_b64(image):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def workers(services):
    """The port's ModelWorker (its own constructor, a model in memory, no
    controller) and JAX's worker around JAX's service, both over HTTP."""
    jservice, _, tservice = services
    tw = tworker.ModelWorker(None, None, None, "psalm-test",
                             limit_concurrency=1, image_size=S,
                             device="cpu", model=tservice.model,
                             tokenizer=tservice.tokenizer)
    tw._segmenter = tservice  # the class names of the JAX side's service
    jw = jworker.ModelWorker.__new__(jworker.ModelWorker)
    jw.semaphore, jw.queue_length = threading.Semaphore(1), 0
    jw._segmenter = jservice
    servers = [_serve(tworker.make_handler(tw)),
               _serve(jworker.make_handler(jw))]
    yield tw, servers[0][1], servers[1][1]
    for srv, _ in servers:
        srv.shutdown()


BAD_REQUESTS = {
    "no image": {"task": "panoptic"},
    "empty image": {"image": "", "task": "semantic"},
    "bad base64": {"image": "not base64 at all!", "task": "panoptic"},
    "not an image": {"image": base64.b64encode(b"plain text").decode()},
    "unknown task": {"task": "detection"},
    "no expression": {"task": "referring"},
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_worker_segment_errors_match_jax(workers, case):
    tw, port_url, jax_url = workers
    params = dict(BAD_REQUESTS[case])
    if "image" not in params and case in ("unknown task", "no expression"):
        params["image"] = _png_b64(_image((8, 8), 0))
    # PIL's message names the buffer by its address
    got, want = (re.sub(r" at 0x[0-9a-f]+", "", json.dumps(
        _post(url + "/worker_segment", params))) for url in (port_url, jax_url))
    assert got == want and json.loads(got)["error_code"] == 1
    assert tw.queue_length == 0


def test_worker_segment_answers_each_task(workers):
    tw, port_url, _ = workers
    image = _image(HW["nonsquare"], 4)
    for task, extra in (("panoptic", {}), ("semantic", {}),
                        ("referring", {"expression": EXPRESSION})):
        got = _post(port_url + "/worker_segment",
                    {"image": _png_b64(image), "task": task, **extra})
        assert got.pop("error_code") == 0
        want = json.loads(json.dumps(tw.segmenter.segment(image, task,
                                                          **extra)))
        assert got == want
        assert (got["height"], got["width"]) == HW["nonsquare"]
    assert tw.queue_length == 0
