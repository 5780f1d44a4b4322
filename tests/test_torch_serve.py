"""The port's HTTP service (`python -m pvpuformer_tpu_torch.serve`) and demo
(`python -m pvpuformer_tpu_torch.demo`) on the CPU: tests/test_serve.py's
session lifecycle against the port's server; two client threads whose
masks equal, bit for bit, controllers driven directly with the same
clicks; the model built once per process, with one int8 copy; the demo's
REPL in process (tiny model) and as a process (ViT-B@448 f32, random
weights)."""
import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pvpuformer_tpu_torch import demo, serve
from pvpuformer_tpu_torch.inference.controller import InteractiveController
from pvpuformer_tpu_torch.inference.predictor import PredictorConfig
from pvpuformer_tpu_torch.models.vpu import init_vpu
from pvpuformer_tpu_torch.nn import QuantLinear
from test_torch_eval import two_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def tiny():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    cfg = PredictorConfig(model=chip_smoke.tiny_config(), target_size=(64, 64),
                          min_crop_size=32)
    return init_vpu(cfg.model, torch.Generator().manual_seed(1), "cpu"), cfg


def _png_b64(arr: np.ndarray) -> str:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _png(b64: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _req(base, path, payload=None, method=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


class Server:
    def __init__(self, make_controller):
        self.srv = serve.build_server(make_controller)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.srv.server_address[1]}"

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _image(seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)


def test_serve_session_lifecycle():
    model, cfg = tiny()
    with Server(lambda: InteractiveController(model, cfg,
                                              device="cpu")) as base:
        assert _req(base, "/healthz")["ok"] is True
        sid = _req(base, "/session", {"image": _png_b64(_image())})["session"]
        out = _req(base, "/click", {"session": sid, "x": 30, "y": 20,
                                    "positive": True})
        assert out["clicks"] == 1 and out["object_area"] >= 0
        out = _req(base, "/click", {"session": sid, "x": 50, "y": 40,
                                    "positive": False})
        assert out["clicks"] == 2
        assert _req(base, "/undo", {"session": sid})["clicks"] == 1
        assert _req(base, "/finish", {"session": sid})["objects"] == 1
        mask = _png(_req(base, "/mask?session=" + sid, method="GET")["mask"])
        assert mask.shape == (64, 64) and set(np.unique(mask)) <= {0, 1}
        vis = _png(_req(base, "/vis?session=" + sid, method="GET")["image"])
        assert vis.shape == (64, 64, 3)
        init = np.zeros((64, 64), np.uint8)
        init[8:24, 8:24] = 255
        _req(base, "/set_mask", {"session": sid, "mask": _png_b64(init)})
        assert _req(base, "/brs_mode", {"session": sid,
                                        "mode": "f-BRS-C"})["mode"] == \
            "f-BRS-C"
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, "/click", {"session": "nope", "x": 1, "y": 1,
                                  "positive": True})
        assert e.value.code == 404
        _req(base, "/session?session=" + sid, method="DELETE")
        assert _req(base, "/healthz")["sessions"] == 0


SCRIPT = ([("click", 30, 20, True), ("click", 50, 40, False),
           ("click", 12.5, 44.5, True), ("click", 40, 10, False),
           ("click", 22, 33, True), ("undo",), ("finish",)]
          + [("click", x, y, p) for x, y, p in
             ((10, 50, True), (15, 45, True), (5, 60, False))])


def _drive_direct(c, image):
    c.set_image(image)
    for op, *args in SCRIPT:
        if op == "click":
            c.add_click(*args)
        elif op == "undo":
            c.undo_click()
        else:
            c.finish_object()
    return c.result_mask


def _drive_http(base, image, out, key):
    sid = _req(base, "/session", {"image": _png_b64(image)})["session"]
    for op, *args in SCRIPT:
        if op == "click":
            x, y, p = args
            _req(base, "/click", {"session": sid, "x": x, "y": y,
                                  "positive": p})
        else:
            _req(base, "/" + op, {"session": sid})
    out[key] = (_png(_req(base, "/mask?session=" + sid, method="GET")["mask"]),
                _png(_req(base, "/vis?session=" + sid, method="GET")["image"]))
    _req(base, "/session?session=" + sid, method="DELETE")


@pytest.mark.parametrize("int8", [False, True])
def test_concurrent_sessions_equal_direct_controllers(int8):
    """Two client threads, one session each, on one shared model (and one
    int8 copy): each mask equals a controller driven directly."""
    model, cfg = tiny()
    args = SimpleNamespace(prob_thresh=0.5, brs_mode="NoBRS", int8=int8,
                           device="cpu")
    made = []

    def make():
        made.append(demo.build_controller(args, model, cfg, shared))
        return made[-1]

    shared = None
    if int8:
        from pvpuformer_tpu_torch.nn import quantize_params
        shared = quantize_params(model)
    out = {}
    with Server(make) as base:
        threads = [threading.Thread(target=_drive_http,
                                    args=(base, _image(s), out, s))
                   for s in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    assert len(made) == 2
    assert all((c.predictor.model is shared) if int8 else
               (c.predictor.model is model) for c in made)
    for s in (0, 1):
        c = demo.build_controller(args, model, cfg, shared)
        want = _drive_direct(c, _image(s))
        mask, vis = out[s]
        assert set(np.unique(want)) <= {0, 1, 2}
        np.testing.assert_array_equal(mask, want)
        np.testing.assert_array_equal(vis, c.get_visualization())


def test_controller_factory_builds_the_model_once(monkeypatch):
    model, cfg = tiny()
    calls = []

    def build_model(args):
        calls.append(args)
        return model, cfg
    monkeypatch.setattr(demo, "build_model", build_model)
    args = serve.parse_args(["--device", "cpu", "--int8", "--port", "0"])
    make = serve.make_controller_factory(args)
    c1, c2 = make(), make()
    assert len(calls) == 1
    assert c1.predictor.model is c2.predictor.model
    assert any(isinstance(m, QuantLinear)
               for m in c1.predictor.model.modules())
    assert not any(isinstance(m, QuantLinear) for m in model.modules())


def test_demo_repl_in_process(tmp_path, monkeypatch, capsys):
    model, cfg = tiny()
    c = InteractiveController(model, cfg, device="cpu")
    c.set_image(_image())
    out = tmp_path / "mask.png"
    vis = tmp_path / "vis.png"
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        f"p 30 20\nn 50 40\nundo\nbogus\np\nfinish\np 10 10\n"
        f"save {out}\nvis {vis}\nquit\np 1 1\n"))
    demo.repl(c, SimpleNamespace(prob_thresh=0.5))
    text = capsys.readouterr().out
    assert "click #1" in text and "object 1 saved" in text
    assert "? bogus" in text and "error:" in text
    assert len(c.clicks_list) == 1                # "p 1 1" came after quit
    from PIL import Image
    saved = np.asarray(Image.open(out))
    np.testing.assert_array_equal(saved, c.result_mask)
    assert np.asarray(Image.open(vis)).shape == (64, 64, 3)


def test_demo_process_on_the_cpu(tmp_path):
    """`python -m pvpuformer_tpu_torch.demo --random-weights --device cpu`
    at ViT-B@448 f32 with REPL commands on stdin writes its mask."""
    out = tmp_path / "mask.png"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "pvpuformer_tpu_torch.demo", "--random-weights",
         "--device", "cpu", "--dtype", "float32"],
        input=f"p 200 220\nsave {out}\nquit\n", cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "click #1 -> object area" in run.stdout
    from PIL import Image
    mask = np.asarray(Image.open(out))
    assert mask.shape == (448, 448) and set(np.unique(mask)) <= {0, 1}


def test_demo_and_serve_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        demo.build_model(demo.parse_args(["--random-weights"]))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.make_controller_factory(serve.parse_args(["--random-weights"]))
