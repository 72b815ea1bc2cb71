"""Minimal browser chat UI served from the stdlib HTTP server.

The reference ships a Gradio UI (psalm/serve/gradio_web_server.py); gradio is
not available in this image, so this serves an equivalent single-page chat
client (image upload + streaming) that talks to the controller's
/worker_generate_stream endpoint.
"""

from __future__ import annotations

import argparse
import json
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PAGE = """<!doctype html><html><head><title>psalm-tpu chat</title><style>
body{font-family:sans-serif;max-width:760px;margin:2em auto}
#log{border:1px solid #ccc;padding:1em;min-height:240px;white-space:pre-wrap}
textarea{width:100%}</style></head><body>
<h2>psalm-tpu chat</h2>
<div id=log></div>
<p><input type=file id=img accept="image/*"></p>
<p><textarea id=msg rows=3 placeholder="Say something..."></textarea></p>
<p><button onclick=send()>Send</button></p>
<script>
async function send(){
  const msg = document.getElementById('msg').value;
  const log = document.getElementById('log');
  log.textContent += 'USER: ' + msg + '\\n';
  let images = [];
  const f = document.getElementById('img').files[0];
  if (f) {
    const b = await f.arrayBuffer();
    images = [btoa(String.fromCharCode(...new Uint8Array(b)))];
  }
  const prompt = (images.length ? '<image>\\n' : '') + msg;
  const r = await fetch('/generate', {method:'POST',
    body: JSON.stringify({model:'psalm', prompt: prompt, images: images,
                          temperature: 0.2, max_new_tokens: 256})});
  const reader = r.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  let line = 'ASSISTANT: ';
  log.textContent += line;
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value);
    const parts = buf.split('\\0');
    buf = parts.pop();
    for (const p of parts) {
      if (!p) continue;
      const obj = JSON.parse(p);
      log.textContent = log.textContent.slice(0, log.textContent.length) ;
      // show the latest cumulative text
      const lines = log.textContent.split('\\n');
      lines[lines.length-1] = 'ASSISTANT: ' + obj.text;
      log.textContent = lines.join('\\n');
    }
  }
  log.textContent += '\\n';
}
</script></body></html>"""


def make_handler(controller_url: str, moderate: bool = False):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/generate":
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            if moderate:
                # moderation hook (reference gradio_web_server.py:143-147)
                import json as _json
                from psalm_tpu_torch.serve.moderation import (
                    MODERATION_MSG, violates_moderation)
                try:
                    prompt = _json.loads(data).get("prompt", "")
                except ValueError:
                    prompt = ""
                if violates_moderation(prompt):
                    body = _json.dumps({"text": MODERATION_MSG,
                                        "error_code": 1}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
            req = urllib.request.Request(
                controller_url + "/worker_generate_stream", data=data,
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
                    self.wfile.flush()

    return Handler


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--controller-url", default="http://localhost:10000")
    p.add_argument("--moderate", action="store_true")
    args = p.parse_args()
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(args.controller_url,
                                              moderate=args.moderate))
    print(f"web ui on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
