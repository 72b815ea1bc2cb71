"""Smoke-test a live worker/controller (reference: psalm/serve/test_message.py)."""

from __future__ import annotations

import argparse
import json
import urllib.request


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--controller-address", default="http://localhost:10000")
    p.add_argument("--worker-address", default=None,
                   help="bypass the controller and hit a worker directly")
    p.add_argument("--model-name", default="psalm")
    p.add_argument("--message", default="Tell me a story with more than 1000 words.")
    p.add_argument("--max-new-tokens", type=int, default=32)
    args = p.parse_args()

    if args.worker_address:
        addr = args.worker_address
    else:
        req = urllib.request.Request(
            args.controller_address + "/get_worker_address",
            data=json.dumps({"model": args.model_name}).encode(),
            headers={"Content-Type": "application/json"})
        addr = json.loads(urllib.request.urlopen(req).read())["address"]
        print("worker address:", addr)
        if not addr:
            return

    payload = {"model": args.model_name, "prompt": args.message,
               "temperature": 0.0, "max_new_tokens": args.max_new_tokens}
    req = urllib.request.Request(
        addr + "/worker_generate_stream", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        buf = b""
        while True:
            chunk = r.read(4096)
            if not chunk:
                break
            buf += chunk
            while b"\0" in buf:
                piece, buf = buf.split(b"\0", 1)
                if piece:
                    print(json.loads(piece)["text"], flush=True)


if __name__ == "__main__":
    main()
