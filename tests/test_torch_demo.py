"""The port's demo server (``python3 -m triplaneturbo_torch.demo``) on a tiny pipeline, CPU.

The server runs in a thread on a free localhost port and is driven over
``http.client`` (64² views, ``demo.SIZE`` patched down from its 256²): ``/generate``
answers with the strip PNG and the OBJ, ``/file`` serves both and refuses a path
outside its root, a sibling directory whose name begins with the root's included
(which the JAX demo's ``startswith`` check lets through).
"""

import http.client
import os
import re
import threading
import urllib.parse

import pytest
import torch

from test_torch_pipeline import PIPE_KW, TINY_SG, TINY_TEXT
from triplaneturbo_torch import demo
from triplaneturbo_torch.models.clip_text import CLIPTextConfig
from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cpu", space_generator_overrides=TINY_SG,
        text_config=CLIPTextConfig(**TINY_TEXT), **PIPE_KW)
    base = tmp_path_factory.mktemp("demo")
    root = base / "outputs" / "demo"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(demo, "SIZE", 64)
        srv = demo.serve(pipe, str(root), port=0, host="127.0.0.1")
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        yield srv, base, root
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def _get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def test_demo_generates_a_strip_and_an_obj(server):
    srv, _, root = server
    status, ctype, body = _get(srv, "/generate?" + urllib.parse.urlencode(
        {"prompt": "a red chair", "seed": 3}))
    assert status == 200 and ctype == "text/html"
    links = [urllib.parse.unquote(p) for p in re.findall(r"/file\?p=([^']+)'", body.decode())]
    assert len(links) == 2
    obj, png = sorted(links, key=lambda p: p.endswith(".png"))
    assert obj.endswith("model.obj") and png.endswith("views.png")
    assert os.path.commonpath([obj, str(root)]) == str(root)
    status, ctype, data = _get(srv, "/file?p=" + urllib.parse.quote(png))
    assert status == 200 and ctype == "image/png" and data.startswith(b"\x89PNG\r\n\x1a\n")
    status, _, data = _get(srv, "/file?p=" + urllib.parse.quote(obj))
    assert status == 200
    lines = data.decode().splitlines()
    assert any(ln.startswith("v ") for ln in lines) and any(ln.startswith("f ") for ln in lines)
    # the same seed gives the same mesh
    _get(srv, "/generate?" + urllib.parse.urlencode({"prompt": "a red chair", "seed": 3}))
    with open(obj) as f:
        assert f.read().splitlines() == lines
    assert _get(srv, "/")[0] == 200 and _get(srv, "/nothing")[0] == 404


def test_demo_file_refuses_paths_outside_its_root(server):
    srv, base, root = server
    sibling = base / "outputs" / "demo2" / "x"
    sibling.parent.mkdir(parents=True, exist_ok=True)
    sibling.write_text("secret")
    assert str(sibling).startswith(str(root))  # what the JAX demo's check would let through
    assert not demo.under_root(str(sibling), str(root))
    for p in (str(sibling), str(root / ".." / "demo2" / "x"), "/etc/hostname", "", str(root)):
        assert _get(srv, "/file?p=" + urllib.parse.quote(p))[0] == 404
    inside = root / "note.txt"
    inside.write_text("ok")
    assert _get(srv, "/file?p=" + urllib.parse.quote(str(inside)))[2] == b"ok"
