"""Manually register a worker with the controller (reference:
psalm/serve/register_worker.py)."""

from __future__ import annotations

import argparse
import json
import urllib.request


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--controller-address", required=True)
    p.add_argument("--worker-name", required=True)
    p.add_argument("--check-heart-beat", action="store_true")
    args = p.parse_args()

    req = urllib.request.Request(
        args.controller_address + "/register_worker",
        data=json.dumps({"worker_name": args.worker_name,
                         "check_heart_beat": args.check_heart_beat,
                         "worker_status": None}).encode(),
        headers={"Content-Type": "application/json"})
    print(urllib.request.urlopen(req).read().decode())


if __name__ == "__main__":
    main()
