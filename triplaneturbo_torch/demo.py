"""Interactive text-to-3D demo: a stdlib HTTP server around the pipeline.

    python3 -m triplaneturbo_torch.demo [--port 7860] [--host 0.0.0.0] [--weights DIR_OR_PTH] \
        [--out outputs/demo] [--device cuda|cpu]

Counterpart of the root ``demo.py``: ``/`` is a prompt form; ``/generate?prompt=...``
runs the pipeline (one request at a time, under a lock; ``&seed=N`` fixes the
latents, else they come from the clock), renders a 4-view 256² strip with
:func:`~triplaneturbo_torch.evaluation.mesh_render.render_mesh_views`, writes it and
a vertex-colored OBJ under ``--out`` and answers with both links; ``/file?p=PATH``
serves a file that lies under ``--out``. Unlike the JAX demo, which checks
``full.startswith(root)`` and so also serves a sibling such as ``outputs/demo2/``,
the check is on whole path components (``os.path.commonpath`` of the resolved
paths). Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import html
import os
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

_PAGE = """<!doctype html>
<html><head><title>TriplaneTurbo</title>
<style>body{font-family:sans-serif;max-width:900px;margin:40px auto}
input{width:70%%;padding:8px}button{padding:8px 16px}
img{max-width:100%%;border:1px solid #ccc;margin-top:16px}</style></head>
<body><h2>TriplaneTurbo &mdash; text to textured mesh</h2>
<form action="/generate" method="get">
<input name="prompt" placeholder="a DSLR photo of a hamburger" autofocus>
<button>Generate</button></form>
%s
</body></html>"""
N_VIEWS, SIZE = 4, 256  # the strip: views of SIZE² each


def under_root(path: str, root: str) -> bool:
    """True when ``path`` resolves to ``root`` or to a file inside it (whole path
    components: ``outputs/demo2/x`` is not under ``outputs/demo``)."""
    full, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([full, root]) == root


def make_handler(pipe, out_dir: str):
    """The request handler class serving ``pipe``, writing under ``out_dir``."""
    import numpy as np
    import torch

    from .evaluation.mesh_render import render_mesh_views
    from .pipelines.triplaneturbo_text_to_3d import export_obj
    from .utils.saving import save_image_grid

    lock = threading.Lock()
    root = os.path.abspath(out_dir)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, data: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _html(self, body: str, code: int = 200):
            self._send((_PAGE % body).encode(), "text/html", code)

        def _generate(self, prompt: str, seed: int) -> str:
            slug = "".join(c if c.isalnum() else "_" for c in prompt)[:60]
            with lock:
                t0 = time.perf_counter()
                gen = torch.Generator(device=pipe.device).manual_seed(seed)
                mesh = pipe(prompt, generator=gen)["mesh"][0]
                views = render_mesh_views(mesh, n_views=N_VIEWS, height=SIZE, width=SIZE)
                images = views.images.float().cpu().numpy()  # waits for the card
                dt = time.perf_counter() - t0
                obj_path = export_obj(mesh, os.path.join(root, slug, "model.obj"))[0]
                png_path = save_image_grid(os.path.join(root, slug, "views.png"),
                                           list(np.asarray(images)))
            q = urllib.parse.quote
            return (f"<p><b>{html.escape(prompt)}</b> &mdash; {dt:.2f}s "
                    f"(<a href='/file?p={q(obj_path)}'>download OBJ</a>)</p>"
                    f"<img src='/file?p={q(png_path)}'>")

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(url.query)
            if url.path == "/":
                return self._html("")
            if url.path == "/generate":
                prompt = (q.get("prompt") or ["a DSLR photo of a hamburger"])[0]
                seed = int((q.get("seed") or [int(time.time()) % 2**31])[0])
                return self._html(self._generate(prompt, seed))
            if url.path == "/file":
                p = (q.get("p") or [""])[0]
                if not p or not under_root(p, root) or not os.path.isfile(p):
                    return self._html("<p>not found</p>", 404)
                with open(p, "rb") as f:
                    data = f.read()
                ctype = "image/png" if p.endswith(".png") else "application/octet-stream"
                return self._send(data, ctype)
            return self._html("<p>not found</p>", 404)

    return Handler


def serve(pipe, out_dir: str, port: int = 7860, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """A bound server (not yet serving: call ``serve_forever``); port 0 takes a free
    one (``server.server_address[1]``)."""
    os.makedirs(out_dir, exist_ok=True)
    return ThreadingHTTPServer((host, port), make_handler(pipe, out_dir))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m triplaneturbo_torch.demo")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--weights", default=None, help="a converted directory or an adapter .pth")
    ap.add_argument("--out", default="outputs/demo")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from .pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(args.weights, device=args.device,
                                                         dtype_str="bfloat16")
    srv = serve(pipe, args.out, args.port, args.host)
    print(f"[triplaneturbo_torch] demo at http://localhost:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
