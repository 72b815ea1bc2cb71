"""Model worker: loads PSALM, registers with the controller, heartbeats,
serves streaming chat generation and segmentation requests.

Counterpart of ``psalm_tpu/serve/model_worker.py`` (behavioral spec:
psalm/serve/model_worker.py, ModelWorker :44, register/heartbeat :74-106,
semaphore-limited generate_stream :122-192). The streaming wire format
matches the reference: JSON chunks terminated by b"\\0". The model runs in
bf16 on ``device`` (the card by default), optionally with int8 or int4 Phi
linears, and concurrent requests that share a padded prompt length decode
as one batch (``serve/batching.py``).

POST ``/worker_segment`` runs the mask heads (panoptic, semantic or
referring, ``serve/segmentation.py``) on the same model and returns COCO
RLEs in the image's own geometry.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from psalm_tpu_torch.data.constants import WORKER_HEART_BEAT_INTERVAL
from psalm_tpu_torch.data.splicer import splice, stack_samples
from psalm_tpu_torch.data.tokenization import tokenize_special


class ModelWorker:
    """``model`` and ``tokenizer``, when given, replace the load from
    ``model_path`` (a model built in memory)."""

    def __init__(self, controller_addr, worker_addr, model_path, model_name,
                 limit_concurrency=5, image_size=1024, load_8bit=False,
                 load_4bit=False, decode_chunk=32, max_batch=4,
                 batch_window_ms=20.0, device="cuda", model=None,
                 tokenizer=None):
        from psalm_tpu_torch.data.mappers import ImageMapper
        from psalm_tpu_torch.models.generation import Generator
        from psalm_tpu_torch.serve.batching import BatchedGenerator
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = str(uuid.uuid4())[:6]
        self.model_name = model_name
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.queue_length = 0

        if model is None:
            from psalm_tpu_torch.models.builder import load_pretrained_model
            # bf16 storage and compute (and optionally int8 or int4 weights)
            # for the decode path: tok/s is bound by the weight reads
            tokenizer, model, _ = load_pretrained_model(
                model_path, dtype=torch.bfloat16, load_8bit=load_8bit,
                load_4bit=load_4bit, device=device)
        self.tokenizer, self.model = tokenizer, model
        self.context_len = model.cfg.phi.max_position_embeddings
        self.decode_chunk = decode_chunk
        self.generator = Generator(self.model, max_len=self.context_len,
                                   device=device)
        # static request batching: concurrent chat requests sharing a
        # padded-prompt bucket decode as ONE batch
        self.batched = BatchedGenerator(
            self.generator,
            eos_id=getattr(self.tokenizer, "eos_token_id", None),
            max_batch=max_batch, window_s=batch_window_ms / 1000.0,
            chunk_size=decode_chunk)
        self.mapper = ImageMapper(image_size)
        self.num_image_tokens = (image_size // 64) ** 2

        if controller_addr:
            self.register()
            t = threading.Thread(target=self._heartbeat_loop, daemon=True)
            t.start()

    # -- controller protocol --------------------------------------------------

    def _post(self, path, payload):
        import urllib.request
        req = urllib.request.Request(
            self.controller_addr + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as r:
            return json.loads(r.read())

    def register(self):
        self._post("/register_worker", {
            "worker_name": self.worker_addr, "check_heart_beat": True,
            "worker_status": self.get_status()})

    def _heartbeat_loop(self):
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                exist = self._post("/receive_heart_beat", {
                    "worker_name": self.worker_addr,
                    "queue_length": self.queue_length})["exist"]
                if not exist:
                    self.register()
            except Exception as e:  # noqa: BLE001 - keep beating
                print("heartbeat error:", e)

    def get_status(self):
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": self.queue_length}

    # -- segmentation ---------------------------------------------------------

    @property
    def segmenter(self):
        if not hasattr(self, "_segmenter"):
            from psalm_tpu_torch.serve.segmentation import SegmentService
            self._segmenter = SegmentService(self.model, self.tokenizer,
                                             self.model.cfg)
        return self._segmenter

    def segment(self, params):
        """params: {image: base64, task: panoptic|semantic|referring,
        expression?: str} -> masks as COCO RLEs (original geometry)."""
        import base64
        import io
        from PIL import Image
        if not params.get("image"):
            return {"error_code": 1, "text": "segment requires 'image'"}
        try:
            img = Image.open(io.BytesIO(base64.b64decode(params["image"])))
            image = np.asarray(img.convert("RGB"))
        except Exception as e:  # noqa: BLE001 - bad base64 or not an image
            return {"error_code": 1,
                    "text": f"could not decode 'image': {e}"}
        task = params.get("task", "panoptic")
        with self.semaphore:
            self.queue_length += 1
            try:
                out = self.segmenter.segment(
                    image, task, expression=params.get("expression"))
                return {"error_code": 0, **out}
            except ValueError as e:
                return {"error_code": 1, "text": str(e)}
            finally:
                self.queue_length -= 1

    # -- generation ------------------------------------------------------------

    def generate_stream(self, params):
        prompt = params["prompt"]
        images = params.get("images")
        temperature = float(params.get("temperature", 0.0))
        max_new_tokens = int(params.get("max_new_tokens", 256))
        stop_str = params.get("stop")

        input_ids = tokenize_special(prompt, self.tokenizer)
        if images:
            import base64
            import io
            from PIL import Image
            img = Image.open(io.BytesIO(base64.b64decode(images[0])))
            proc = self.mapper.transform_image(np.asarray(img.convert("RGB")))
            image_arr = proc.image[None]
        else:
            image_arr = np.zeros((1, self.mapper.image_size,
                                  self.mapper.image_size, 3), np.float32)
        # bucket the padded length: every distinct pad_len is a separate
        # batching group, so rounding up to 64 lets unrelated prompts share
        raw_len = len(input_ids) + self.num_image_tokens + 8
        pad_len = -(-raw_len // 64) * 64
        s = splice(input_ids, None, num_image_tokens=self.num_image_tokens,
                   num_seg_queries=1, pad_len=pad_len)
        batch = stack_samples([s])
        batch["images"] = image_arr

        with self.semaphore:
            self.queue_length += 1
            try:
                toks = []
                for tok in self.batched.submit(batch, max_new_tokens,
                                               temperature):
                    toks.append(int(tok))
                    piece = self.tokenizer.decode(toks,
                                                  skip_special_tokens=True)
                    if stop_str and stop_str in piece:
                        piece = piece[:piece.index(stop_str)]
                        yield json.dumps({"text": prompt + piece,
                                          "error_code": 0}).encode() + b"\0"
                        return
                    yield json.dumps({"text": prompt + piece,
                                      "error_code": 0}).encode() + b"\0"
            finally:
                self.queue_length -= 1


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _read(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            if self.path == "/worker_generate_stream":
                params = self._read()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream(params):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            elif self.path == "/worker_segment":
                body = json.dumps(worker.segment(self._read())).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/worker_get_status":
                body = json.dumps(worker.get_status()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21002)
    p.add_argument("--worker-address", default="http://localhost:21002")
    p.add_argument("--controller-address", default="http://localhost:10000")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-name", default="psalm")
    p.add_argument("--limit-model-concurrency", type=int, default=5)
    p.add_argument("--load-8bit", action="store_true",
                   help="weight-only int8 Phi linears (bnb load_in_8bit "
                        "analog)")
    p.add_argument("--load-4bit", action="store_true",
                   help="packed int4 group-quantized Phi linears (bnb "
                        "load_in_4bit analog); set quant_storage='pallas' in "
                        "the config for the K4 decode kernel")
    p.add_argument("--decode-chunk", type=int, default=32,
                   help="tokens decoded per host sync in streaming decode")
    p.add_argument("--max-batch", type=int, default=4,
                   help="max concurrent requests decoded as one batch")
    p.add_argument("--batch-window-ms", type=float, default=20.0,
                   help="how long an underfull batch waits for stragglers")
    args = p.parse_args()
    worker = ModelWorker(args.controller_address, args.worker_address,
                         args.model_path, args.model_name,
                         args.limit_model_concurrency,
                         load_8bit=args.load_8bit,
                         load_4bit=args.load_4bit,
                         decode_chunk=args.decode_chunk,
                         max_batch=args.max_batch,
                         batch_window_ms=args.batch_window_ms)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(worker))
    print(f"worker listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
