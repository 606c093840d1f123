"""HTTP inference server over a serving artifact (port of
esr_tpu/scripts/serve.py; stdlib HTTP server)::

    python -m esr_tpu_torch.scripts.serve --artifact /path/artifact --port 8008 [--device cuda|cpu]

Protocol (one request = one image), as the JAX package's:

- ``POST /sr`` with a PNG body (other formats where PIL is installed) ->
  PNG SR image. Optional headers ``X-Z-Mode: zeros|random`` (default zeros)
  and ``X-Z-Seed: <int>`` for reproducible random-Z draws on explorable
  artifacts; ``random`` without a seed draws fresh entropy per request.
- ``GET /healthz`` -> 200 with the manifest (JSON).
- 400 for an image that does not decode or fits no bucket, 404 for other
  paths, 500 with the exception's text for anything else.

The SR is clipped to [0,1] and rounded exactly as the eval loop does
(``tensor2img``) before PNG encoding. One lock serialises the forwards (one
device). ``make_server`` runs one forward per bucket in the calling thread,
so that the kernels are built there and not inside a handler thread.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from esr_tpu_torch.data import png
from esr_tpu_torch.data.util import decode_image
from esr_tpu_torch.export import load_servable
from esr_tpu_torch.ops.color import tensor2img

__all__ = ["main", "make_server"]


def _decode_rgb(body: bytes) -> np.ndarray:
    """Request body -> HWC RGB float32 in [0,1] (gray replicated to RGB)."""
    img = decode_image(body, "request body")
    scale = 65535.0 if img.dtype == np.uint16 else 255.0
    img = img.astype(np.float32) / scale
    return np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img


def make_server(artifact_dir: str, host: str = "127.0.0.1", port: int = 8008, device="cuda"):
    """Build (not start) the server: a ThreadingHTTPServer whose
    ``serve_forever()`` / ``shutdown()`` the caller owns. Loads the artifact
    and runs one forward per bucket here, in the caller's thread (on the
    card that call captures the bucket's CUDA graph, so no request pays for
    a capture)."""
    servable = load_servable(artifact_dir, device)
    for b, h, w in servable.buckets:
        servable.sr(np.zeros((b, h, w, 3), np.float32))
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path == "/healthz":
                self._reply(200, json.dumps(servable.manifest).encode(), "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):  # noqa: N802
            if self.path != "/sr":
                self._reply(404, b"not found", "text/plain")
                return
            try:
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                try:
                    lr = _decode_rgb(body)
                except ValueError as e:  # any decode failure is the client's
                    self._reply(400, f"bad image: {e}".encode(), "text/plain")
                    return
                z = None
                if servable.nz and (self.headers.get("X-Z-Mode") or "zeros").lower() == "random":
                    seed = self.headers.get("X-Z-Seed")
                    rng = np.random.default_rng(None if seed is None else int(seed))
                    z = rng.uniform(-1, 1, lr.shape[:2] + (servable.nz,)).astype(np.float32)
                with lock:
                    sr = servable.sr(lr, z)[0]
                self._reply(200, png.encode(tensor2img(sr)), "image/png")
            except ValueError as e:  # no fitting bucket, bad seed
                self._reply(400, str(e).encode(), "text/plain")
            except Exception as e:  # noqa: BLE001 — report it and keep the daemon up
                self._reply(500, f"{type(e).__name__}: {e}".encode(), "text/plain")

    server = ThreadingHTTPServer((host, port), Handler)
    server.servable = servable  # for callers and tests
    return server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--artifact", required=True, help="export_model output dir")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    server = make_server(args.artifact, args.host, args.port, args.device)
    m = server.servable.manifest
    print(f"serving x{m['scale']} SR on http://{args.host}:{args.port} "
          f"(buckets: {server.servable.buckets}, device {server.servable.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
