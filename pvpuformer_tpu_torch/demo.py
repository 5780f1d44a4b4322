"""Interactive segmentation demo of the port (the repository's demo.py;
reference `demo.py` + `interactive_demo/`).

Two frontends over the same InteractiveController session API
(pvpuformer_tpu_torch/inference/controller.py):

  * headless REPL (default — works over ssh):
        python -m pvpuformer_tpu_torch.demo --checkpoint ckpt.npz \
            --image photo.jpg [--device cpu]
    commands:  p X Y  (positive click)   n X Y  (negative click)
               undo | finish | save OUT.png | vis OUT.jpg | quit
  * Tk GUI (`--gui`), the interactive_demo/app.py:14-334 equivalent:
    left/right click = positive/negative, zoomable canvas (mouse wheel
    zoom about the cursor, middle-drag pan — canvas.py:49-324 machinery as
    the headless `ViewTransform`), BRS-mode selector (all six modes),
    prediction-threshold and alpha-blend sliders, click-radius control,
    open image / load init mask / save mask, undo / reset clicks / finish
    object. tkinter is imported only here.

It runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

BRS_MODES = ["NoBRS", "f-BRS-A", "f-BRS-B", "f-BRS-C", "RGB-BRS",
             "DistMap-BRS"]


class ViewTransform:
    """Zoomable-canvas coordinate machinery, headless-testable
    (interactive_demo/canvas.py:49-324 re-derivation): a zoom factor and a
    pan offset map image coords -> widget coords; `zoom` scales about the
    cursor; `pan` drags; `to_image` inverts widget clicks (None outside
    the image); `render` crops + resizes the visible region.
    """

    def __init__(self, img_hw, view_wh, min_zoom: float = 1.0,
                 max_zoom: float = 16.0):
        self.ih, self.iw = img_hw
        self.vw, self.vh = view_wh
        # fit-to-view base scale (app shows the whole image initially)
        self.base = min(self.vw / self.iw, self.vh / self.ih)
        self.zoom_level = 1.0
        self.min_zoom = min_zoom
        self.max_zoom = max_zoom
        self.ox = 0.0      # image coords of the view's top-left corner
        self.oy = 0.0

    @property
    def scale(self) -> float:
        return self.base * self.zoom_level

    def _clamp(self) -> None:
        vis_w = self.vw / self.scale
        vis_h = self.vh / self.scale
        self.ox = max(0.0, min(self.ox, max(0.0, self.iw - vis_w)))
        self.oy = max(0.0, min(self.oy, max(0.0, self.ih - vis_h)))

    def zoom(self, factor: float, wx: float, wy: float) -> None:
        """Zoom about the widget point (wx, wy)."""
        ix, iy = self.ox + wx / self.scale, self.oy + wy / self.scale
        self.zoom_level = max(self.min_zoom,
                              min(self.max_zoom, self.zoom_level * factor))
        self.ox = ix - wx / self.scale
        self.oy = iy - wy / self.scale
        self._clamp()

    def pan(self, dwx: float, dwy: float) -> None:
        self.ox -= dwx / self.scale
        self.oy -= dwy / self.scale
        self._clamp()

    def to_image(self, wx: float, wy: float):
        ix = self.ox + wx / self.scale
        iy = self.oy + wy / self.scale
        if 0 <= ix < self.iw and 0 <= iy < self.ih:
            return ix, iy
        return None

    def render(self, panel: np.ndarray) -> np.ndarray:
        """Visible crop of the full-resolution panel, resized to the
        view."""
        from PIL import Image
        vis_w = min(self.iw - self.ox, self.vw / self.scale)
        vis_h = min(self.ih - self.oy, self.vh / self.scale)
        x0, y0 = int(self.ox), int(self.oy)
        x1 = min(self.iw, int(np.ceil(self.ox + vis_w)))
        y1 = min(self.ih, int(np.ceil(self.oy + vis_h)))
        crop = panel[y0:y1, x0:x1]
        out_w = max(1, int(round((x1 - x0) * self.scale)))
        out_h = max(1, int(round((y1 - y0) * self.scale)))
        img = Image.fromarray(crop).resize((out_w, out_h),
                                           Image.NEAREST if self.scale > 4
                                           else Image.BILINEAR)
        return np.asarray(img)


@dataclasses.dataclass
class DemoSettings:
    """GUI-adjustable state (the app.py:200-280 menu/slider block)."""
    brs_mode: str = "NoBRS"
    prob_thresh: float = 0.5
    alpha_blend: float = 0.6
    click_radius: int = 4


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--image", required=False, default=None)
    p.add_argument("--gui", action="store_true")
    p.add_argument("--prob-thresh", type=float, default=0.5)
    p.add_argument("--brs-mode", default="NoBRS", choices=BRS_MODES)
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ serving path (NoBRS only)")
    p.add_argument("--target-size", type=int, default=448,
                   help="zoom-in crop of a model without a ViT backbone (a "
                        "zoo checkpoint); a ViT model uses its own crop")
    p.add_argument("--limit-longest-size", type=int, default=800,
                   help="host-resize larger images down before the session "
                        "(reference demo.py --limit-longest-size, "
                        "transforms/limit_longest_side.py); 0 disables")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    return p.parse_args(argv)


def build_model(args):
    """(model on `args.device`, its PredictorConfig): from a checkpoint in
    the JAX package's format, or ViT-B@448 with seeded random weights."""
    import torch
    from .inference.predictor import PredictorConfig
    from .models import registry
    from .models.vpu import init_vpu, vpu_base_config
    from .nn import resolve_device
    from .utils.serialization import load_checkpoint

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.checkpoint:
        flat, cfg, _, _ = load_checkpoint(args.checkpoint)
        mcfg = (cfg.model if hasattr(cfg, "model") else cfg).replace(
            dtype=dtype)
        model = registry.load(flat, mcfg)
    else:
        if not args.random_weights:
            raise SystemExit("--checkpoint or --random-weights required")
        mcfg = vpu_base_config(dtype=dtype)
        model = init_vpu(mcfg, torch.Generator().manual_seed(0), "cpu")
    ts = registry.crop_size(mcfg) or (args.target_size, args.target_size)
    pcfg = PredictorConfig(model=mcfg, target_size=ts, prob_thresh=0.49,
                           limit_longest_side=args.limit_longest_size)
    return model.to(device), pcfg


def build_controller(args, model=None, pcfg=None, int8_model=None):
    """A controller on `args.device`; `model` / `pcfg` from `build_model`
    (built here when not given) and `int8_model` are shared when a server
    builds one controller per session."""
    from .inference.controller import InteractiveController
    if model is None:
        model, pcfg = build_model(args)
    return InteractiveController(model, pcfg, prob_thresh=args.prob_thresh,
                                 brs_mode=args.brs_mode,
                                 int8=getattr(args, "int8", False),
                                 device=args.device, int8_model=int8_model)


def load_image(path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def repl(controller, args) -> None:
    from PIL import Image
    print("commands: p X Y | n X Y | undo | finish | save OUT | vis OUT | quit")
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        cmd = parts[0].lower()
        try:
            if cmd in ("p", "n"):
                x, y = float(parts[1]), float(parts[2])
                controller.add_click(x, y, cmd == "p")
                area = int((controller.current_object_prob
                            > args.prob_thresh).sum())
                print(f"click #{len(controller.clicks_list)} -> "
                      f"object area {area} px")
            elif cmd == "undo":
                controller.undo_click()
                print(f"{len(controller.clicks_list)} clicks")
            elif cmd == "finish":
                controller.finish_object()
                print(f"object {controller.object_count} saved")
            elif cmd == "save":
                Image.fromarray(controller.result_mask.astype(np.uint16)).save(parts[1])
                print("mask ->", parts[1])
            elif cmd == "vis":
                Image.fromarray(controller.get_visualization()).save(parts[1])
                print("panel ->", parts[1])
            elif cmd in ("quit", "exit", "q"):
                return
            else:
                print("?", cmd)
        except (IndexError, ValueError) as e:
            print("error:", e)


def gui(controller, args) -> None:
    """Tk frontend (interactive_demo/app.py:14-334 equivalent): zoomable
    canvas, BRS selector, threshold/alpha sliders, mask load/save."""
    import tkinter as tk
    from tkinter import filedialog
    from PIL import Image, ImageTk

    settings = DemoSettings(prob_thresh=args.prob_thresh)
    root = tk.Tk()
    root.title("pvpuformer demo")
    VIEW_W, VIEW_H = 900, 700
    canvas = tk.Canvas(root, width=VIEW_W, height=VIEW_H, bg="#202020")
    canvas.pack(side="left", fill="both")
    view = {"t": ViewTransform(controller.image.shape[:2],
                               (VIEW_W, VIEW_H))}
    photo = {"img": None}
    drag = {"xy": None}

    def redraw():
        controller.prob_thresh = settings.prob_thresh
        panel = controller.get_visualization(
            alpha_blend=settings.alpha_blend,
            click_radius=settings.click_radius)
        photo["img"] = ImageTk.PhotoImage(
            Image.fromarray(view["t"].render(panel)))
        canvas.delete("all")
        canvas.create_image(0, 0, anchor="nw", image=photo["img"])

    def click(event, positive):
        pt = view["t"].to_image(event.x, event.y)
        if pt is not None:
            controller.add_click(pt[0], pt[1], positive)
            redraw()

    def wheel(event, step=None):
        factor = 1.25 if (step or event.delta) > 0 else 0.8
        view["t"].zoom(factor, event.x, event.y)
        redraw()

    def pan_start(event):
        drag["xy"] = (event.x, event.y)

    def pan_move(event):
        if drag["xy"] is not None:
            view["t"].pan(event.x - drag["xy"][0], event.y - drag["xy"][1])
            drag["xy"] = (event.x, event.y)
            redraw()

    canvas.bind("<Button-1>", lambda e: click(e, True))
    canvas.bind("<Button-3>", lambda e: click(e, False))
    canvas.bind("<MouseWheel>", wheel)
    canvas.bind("<Button-4>", lambda e: wheel(e, step=1))    # X11
    canvas.bind("<Button-5>", lambda e: wheel(e, step=-1))
    canvas.bind("<ButtonPress-2>", pan_start)
    canvas.bind("<B2-Motion>", pan_move)
    canvas.bind("<ButtonRelease-2>", lambda e: drag.update(xy=None))

    # focus-aware wrappers (demo_widgets, re-derived from the reference's
    # interactive_demo/wrappers.py): click-to-focus controls + validated
    # numeric entry, grouped in labeled frames like the reference app
    from .demo_widgets import make_widgets
    W = make_widgets()

    side = tk.Frame(root)
    side.pack(side="right", fill="y", padx=4)

    def set_image_from(path):
        img = load_image(path)
        controller.set_image(img)
        view["t"] = ViewTransform(img.shape[:2], (VIEW_W, VIEW_H))
        redraw()

    io_frame = W["FocusLabelFrame"](side, text="Image / mask")
    io_frame.pack(fill="x", pady=(0, 4))
    W["FocusButton"](io_frame, text="open image", command=lambda: (
        (lambda p: set_image_from(p) if p else None)(
            filedialog.askopenfilename()))).pack(fill="x")

    def load_mask():
        path = filedialog.askopenfilename()
        if path:
            m = np.asarray(Image.open(path).convert("L")) > 0
            controller.set_mask(m.astype(np.float32))
            redraw()
    W["FocusButton"](io_frame, text="load init mask",
                     command=load_mask).pack(fill="x")

    def save_mask():
        path = filedialog.asksaveasfilename(defaultextension=".png")
        if path:
            Image.fromarray(
                controller.result_mask.astype(np.uint16)).save(path)
    W["FocusButton"](io_frame, text="save mask",
                     command=save_mask).pack(fill="x")

    brs_frame = W["FocusLabelFrame"](side, text="BRS mode")
    brs_frame.pack(fill="x", pady=(0, 4))
    mode_var = tk.StringVar(value=settings.brs_mode)

    def on_mode(_):
        settings.brs_mode = mode_var.get()
        controller.set_brs_mode(settings.brs_mode)
        redraw()
    tk.OptionMenu(brs_frame, mode_var, *BRS_MODES,
                  command=on_mode).pack(fill="x")

    # network clicks limit: validated entry, INF = no truncation
    # (reference app.py's net_clicks_limit BoundedNumericalEntry)
    limit_row = tk.Frame(brs_frame)
    limit_row.pack(fill="x")
    tk.Label(limit_row, text="network clicks").pack(side="left")
    limit_var = tk.StringVar(value="INF")

    def on_limit(*_):
        v = limit_var.get()
        controller.set_net_clicks_limit(None if v == "INF" else int(v))
        redraw()
    entry = W["BoundedNumericalEntry"](limit_row, min_value=1, max_value=96,
                                       vartype=int, allow_inf=True,
                                       variable=limit_var)
    entry.fake_var.set("INF")
    entry.bind("<Return>", on_limit)
    entry.bind("<FocusOut>", on_limit)
    entry.pack(side="right")

    vis_frame = W["FocusLabelFrame"](side, text="Visualization")
    vis_frame.pack(fill="x", pady=(0, 4))

    def slider(label, frm, to, res, init, setter):
        tk.Label(vis_frame, text=label).pack()
        s = W["FocusHorizontalScale"](
            vis_frame, from_=frm, to=to, resolution=res,
            command=lambda v: (setter(float(v)), redraw()))
        s.set(init)
        s.pack(fill="x")

    slider("prediction threshold", 0.0, 1.0, 0.01, settings.prob_thresh,
           lambda v: setattr(settings, "prob_thresh", v))
    slider("alpha blend", 0.0, 1.0, 0.05, settings.alpha_blend,
           lambda v: setattr(settings, "alpha_blend", v))
    slider("click radius", 1, 10, 1, settings.click_radius,
           lambda v: setattr(settings, "click_radius", int(v)))

    clicks_frame = W["FocusLabelFrame"](side, text="Clicks")
    clicks_frame.pack(fill="x", pady=(8, 0))
    W["FocusButton"](clicks_frame, text="undo click", command=lambda: (
        controller.undo_click(), redraw())).pack(fill="x")
    W["FocusButton"](clicks_frame, text="reset clicks", command=lambda: (
        controller.reset_last_object(), redraw())).pack(fill="x")
    W["FocusButton"](clicks_frame, text="finish object", command=lambda: (
        controller.finish_object(), redraw())).pack(fill="x")

    redraw()
    root.mainloop()


def main(argv=None) -> None:
    args = parse_args(argv)
    controller = build_controller(args)
    if args.image:
        controller.set_image(load_image(args.image))
    else:
        rng = np.random.default_rng(0)
        controller.set_image(
            (rng.uniform(size=(448, 448, 3)) * 255).astype(np.uint8))
        print("(no --image given: using a random test image)")
    if args.gui:
        gui(controller, args)
    else:
        repl(controller, args)


if __name__ == "__main__":
    main()
