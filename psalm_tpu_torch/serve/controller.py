"""Serving controller — worker registry, heartbeats, dispatch, stream proxy.

Behavioral spec: psalm/serve/controller.py (FastAPI): endpoints
/register_worker, /refresh_all_workers, /list_models, /get_worker_address,
/receive_heart_beat, /worker_generate_stream, /worker_get_status
(controller.py:242-284), 30 s heartbeat expiry (constants.py:1-2),
lottery / shortest-queue dispatch (controller.py:120-180). Implemented on
the stdlib ThreadingHTTPServer (FastAPI is not available in this image);
the HTTP contract is identical.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

import numpy as np

from psalm_tpu_torch.data.constants import CONTROLLER_HEART_BEAT_EXPIRATION


@dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float = field(default_factory=time.time)


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.workers: Dict[str, WorkerInfo] = {}
        self.dispatch_method = dispatch_method
        self.lock = threading.Lock()

    def register_worker(self, name: str, check_heart_beat: bool,
                        status: dict | None) -> bool:
        with self.lock:
            status = status or {"model_names": [], "speed": 1, "queue_length": 0}
            self.workers[name] = WorkerInfo(
                model_names=status["model_names"], speed=status["speed"],
                queue_length=status["queue_length"],
                check_heart_beat=check_heart_beat)
        return True

    def remove_stale_workers(self) -> None:
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self.lock:
            dead = [n for n, w in self.workers.items()
                    if w.check_heart_beat and w.last_heart_beat < expire]
            for n in dead:
                del self.workers[n]

    def list_models(self) -> List[str]:
        self.remove_stale_workers()
        names = set()
        for w in self.workers.values():
            names.update(w.model_names)
        return sorted(names)

    def get_worker_address(self, model_name: str) -> str:
        self.remove_stale_workers()
        with self.lock:
            cands = [(n, w) for n, w in self.workers.items()
                     if model_name in w.model_names]
            if not cands:
                return ""
            if self.dispatch_method == "lottery":
                speeds = np.array([w.speed for _, w in cands], np.float32)
                speeds = speeds / speeds.sum()
                return cands[int(np.random.choice(len(cands), p=speeds))][0]
            # shortest queue normalized by speed (controller.py:160-178)
            qlen = [w.queue_length / max(w.speed, 1e-6) for _, w in cands]
            i = int(np.argmin(qlen))
            cands[i][1].queue_length += 1
            return cands[i][0]

    def receive_heart_beat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            if name not in self.workers:
                return False
            self.workers[name].queue_length = queue_length
            self.workers[name].last_heart_beat = time.time()
            return True


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            data = self._read()
            if self.path == "/register_worker":
                ok = controller.register_worker(
                    data["worker_name"], data.get("check_heart_beat", True),
                    data.get("worker_status"))
                self._json({"exist": ok})
            elif self.path == "/refresh_all_workers":
                controller.remove_stale_workers()
                self._json({})
            elif self.path == "/list_models":
                self._json({"models": controller.list_models()})
            elif self.path == "/get_worker_address":
                self._json({"address": controller.get_worker_address(
                    data["model"])})
            elif self.path == "/receive_heart_beat":
                ok = controller.receive_heart_beat(data["worker_name"],
                                                   data["queue_length"])
                self._json({"exist": ok})
            elif self.path == "/worker_generate_stream":
                # proxy to the chosen worker, re-streaming chunks
                import urllib.request
                addr = controller.get_worker_address(data["model"])
                if not addr:
                    self._json({"text": "No available worker.",
                                "error_code": 2})
                    return
                req = urllib.request.Request(
                    addr + "/worker_generate_stream",
                    data=json.dumps(data).encode(),
                    headers={"Content-Type": "application/json"})
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                with urllib.request.urlopen(req) as r:
                    while True:
                        chunk = r.read(4096)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
            elif self.path == "/worker_get_status":
                self._json({"model_names": controller.list_models(),
                            "speed": 1, "queue_length": 0})
            else:
                self._json({"error": "unknown endpoint"}, 404)

    return Handler


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10000)
    p.add_argument("--dispatch-method", default="shortest_queue",
                   choices=["lottery", "shortest_queue"])
    args = p.parse_args()
    controller = Controller(args.dispatch_method)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(controller))
    print(f"controller listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
