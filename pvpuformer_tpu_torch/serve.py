"""Interactive-segmentation HTTP service of the port (the repository's
scripts/serve.py).

The reference has no serving story (its only interactive surface is the Tk
app, `interactive_demo/app.py`); this exposes the InteractiveController
session API over plain HTTP (stdlib only — no web-framework dependency),
one model instance shared across sessions:

    python -m pvpuformer_tpu_torch.serve --checkpoint ckpt.npz --port 8080 \
        [--int8] [--device cpu]

Protocol (JSON bodies; images/masks are base64-encoded PNG):

    POST /session            {"image": <b64 png>}        -> {"session": id}
    POST /click              {"session", "x", "y", "positive"} ->
                             {"clicks": n, "object_area": px}
    POST /undo               {"session"}                 -> {"clicks": n}
    POST /finish             {"session"}                 -> {"objects": n}
    POST /set_mask           {"session", "mask": <b64 png>} -> {}
    POST /brs_mode           {"session", "mode": "NoBRS"|...} -> {}
    GET  /mask?session=ID    -> {"mask": <b64 png, uint16 object ids>}
    GET  /vis?session=ID     -> {"image": <b64 png blended panel>}
    DELETE /session?session=ID
    GET  /healthz            -> {"ok": true, "sessions": n}

Sessions hold device state (the fused predictor's SessionState); requests
for one session are serialized with a per-session lock, different sessions
run at once on the one model (with --int8, on one quantized copy of it).
It runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


def _png_to_array(b64: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _array_to_png(arr: np.ndarray) -> str:
    from PIL import Image
    if arr.dtype == np.uint16:
        # Image.fromarray(..., mode=...) is deprecated (removed in Pillow 13);
        # build the 16-bit image from the raw buffer instead.
        h, w = arr.shape
        img = Image.frombuffer(
            "I;16", (w, h), np.ascontiguousarray(arr).tobytes(), "raw",
            "I;16", 0, 1)
    else:
        img = Image.fromarray(arr)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


class SessionStore:
    """Controller per session id, with per-session locks."""

    def __init__(self, make_controller):
        self._make = make_controller
        self._lock = threading.Lock()
        self._sessions = {}

    def create(self, image: np.ndarray) -> str:
        sid = uuid.uuid4().hex[:12]
        c = self._make()
        c.set_image(image)
        with self._lock:
            self._sessions[sid] = (c, threading.Lock())
        return sid

    def get(self, sid: str):
        with self._lock:
            if sid not in self._sessions:
                raise KeyError(sid)
            return self._sessions[sid]

    def drop(self, sid: str) -> None:
        with self._lock:
            self._sessions.pop(sid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)


def make_handler(store: SessionStore):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):            # quiet by default
            pass

        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _with_session(self, sid, fn):
            try:
                controller, lock = store.get(sid)
            except KeyError:
                return self._json(404, {"error": f"unknown session {sid}"})
            with lock:
                return fn(controller)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/healthz":
                return self._json(200, {"ok": True, "sessions": len(store)})
            if url.path == "/mask":
                return self._with_session(q.get("session"), lambda c: self._json(
                    200, {"mask": _array_to_png(c.result_mask)}))
            if url.path == "/vis":
                return self._with_session(q.get("session"), lambda c: self._json(
                    200, {"image": _array_to_png(c.get_visualization())}))
            return self._json(404, {"error": "not found"})

        def do_DELETE(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/session":
                store.drop(q.get("session"))
                return self._json(200, {})
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            try:
                body = self._body()
            except (ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})

            if url.path == "/session":
                image = _png_to_array(body["image"])
                if image.ndim == 2:
                    image = np.stack([image] * 3, axis=-1)
                sid = store.create(image[..., :3].astype(np.uint8))
                return self._json(200, {"session": sid})

            sid = body.get("session")
            if url.path == "/click":
                def run(c):
                    c.add_click(float(body["x"]), float(body["y"]),
                                bool(body["positive"]))
                    area = int((c.current_object_prob
                                > c.prob_thresh).sum())
                    return self._json(200, {"clicks": len(c.clicks_list),
                                            "object_area": area})
                return self._with_session(sid, run)
            if url.path == "/undo":
                def run(c):
                    c.undo_click()
                    return self._json(200, {"clicks": len(c.clicks_list)})
                return self._with_session(sid, run)
            if url.path == "/finish":
                def run(c):
                    c.finish_object()
                    return self._json(200, {"objects": c.object_count})
                return self._with_session(sid, run)
            if url.path == "/set_mask":
                def run(c):
                    mask = (_png_to_array(body["mask"]) > 0)
                    c.set_mask(mask.astype(np.float32))
                    return self._json(200, {})
                return self._with_session(sid, run)
            if url.path == "/brs_mode":
                def run(c):
                    c.set_brs_mode(body["mode"])
                    return self._json(200, {"mode": c.brs_mode})
                return self._with_session(sid, run)
            return self._json(404, {"error": "not found"})

    return Handler


def build_server(make_controller, host: str = "127.0.0.1", port: int = 0):
    """Returns a ThreadingHTTPServer ready for serve_forever()."""
    store = SessionStore(make_controller)
    return ThreadingHTTPServer((host, port), make_handler(store))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--prob-thresh", type=float, default=0.5)
    p.add_argument("--brs-mode", default="NoBRS")
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ serving path (NoBRS only)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    args.limit_longest_size = 800
    args.target_size = 448             # a zoo checkpoint's crop, as JAX's
    return args


def make_controller_factory(args):
    """The model (and with --int8 its one quantized copy) is built once; each
    session's controller uses it."""
    from . import demo as demo_mod
    from .nn import quantize_params
    model, pcfg = demo_mod.build_model(args)
    int8_model = (quantize_params(model, dtype=pcfg.model.dtype)
                  if args.int8 else None)

    def make_controller():
        return demo_mod.build_controller(args, model, pcfg, int8_model)
    return make_controller


def main(argv=None) -> None:
    args = parse_args(argv)
    srv = build_server(make_controller_factory(args), args.host, args.port)
    print(f"serving on http://{args.host}:{srv.server_address[1]}",
          flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
