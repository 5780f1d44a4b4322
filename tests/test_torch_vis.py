"""The port's visualization helpers (pvpuformer_tpu_torch/utils/vis.py)
pixel-equal to the JAX package's, and its PNG writer read back by PIL."""
from types import SimpleNamespace

import numpy as np
import pytest

from pvpuformer_tpu.utils import vis as jvis
from pvpuformer_tpu_torch.utils import vis as tvis


def _scene(seed=0, h=40, w=52):
    r = np.random.default_rng(seed)
    image = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    inst = np.zeros((h, w), np.int32)
    inst[5:20, 6:25] = 1
    inst[22:38, 30:50] = 2
    inst[10:14, 40:44] = 7
    probs = r.uniform(size=(h, w)).astype(np.float32)
    clicks = np.full((8, 3), -1.0, np.float32)
    clicks[:3] = [(10, 12, 0), (15, 20, 2), (30, 40, 5)]
    clicks[4:6] = [(2, 2, 1), (35, 8, 3)]
    box = np.array([[30, 20, 24, 14, 0]], np.float32)
    scribble = np.stack([np.linspace(3, 48, 60), np.linspace(4, 36, 60)],
                        axis=1).astype(np.float32)
    return image, inst, probs, clicks, box, scribble


def _clicks(arr):
    """Reference-style click objects (.is_positive, .coords, .indx)."""
    n = len(arr) // 2
    return [SimpleNamespace(is_positive=i < n, coords=(int(y), int(x)),
                            indx=int(o))
            for i, (y, x, o) in enumerate(arr) if o >= 0]


CASES = {
    "visualize_mask": lambda v, s: v.visualize_mask(s[1]),
    "draw_probmap": lambda v, s: v.draw_probmap(s[2]),
    "draw_points_markers": lambda v, s: v.draw_points(
        s[0], [(y, x, o) for y, x, o in s[3] if o >= 0], (0, 255, 0)),
    "draw_points_disks": lambda v, s: v.draw_points(
        s[0], [(5, 6), (30, 45)], (255, 0, 0), radius=3),
    "blend_clicks": lambda v, s: v.draw_with_blend_and_clicks(
        s[0], mask=s[1], clicks_list=s[3]),
    "blend_order_markers": lambda v, s: v.draw_with_blend_and_clicks(
        s[0], clicks_list=s[3], order_markers=True),
    "blend_click_objects": lambda v, s: v.draw_with_blend_and_clicks(
        s[0], mask=s[1] > 0, alpha=0.3, clicks_list=_clicks(s[3])),
    "draw_box": lambda v, s: v.draw_box(s[0], s[4][0]),
    "draw_scribble": lambda v, s: v.draw_scribble(s[0], s[5]),
    "blend_prompts": lambda v, s: v.draw_with_blend_and_prompts(
        s[0], mask=s[1], clicks_list=s[3], boxes=s[4], scribbles=s[5][None]),
    "get_boundaries": lambda v, s: v.get_boundaries(s[1], 2),
    "visualize_instances": lambda v, s: v.visualize_instances(
        s[1], boundaries_color=(0, 0, 255), boundaries_width=2),
    "draw_heatmap": lambda v, s: v.draw_heatmap(s[0], mask=s[1] > 0),
    "error_map": lambda v, s: v.error_map(s[1] > 0, s[2] > 0.5),
    "draw_with_error_clicks": lambda v, s: v.draw_with_error(
        s[1] > 0, s[2] > 0.5, clicks_list=s[3], prompt_type=0),
    "draw_with_error_box": lambda v, s: v.draw_with_error(
        s[1] > 0, s[2] > 0.5, boxes=s[4], prompt_type=1),
    "draw_with_error_scribble": lambda v, s: v.draw_with_error(
        s[1] > 0, s[2] > 0.5, scribbles=s[5], prompt_type=2),
    "annotate_iou_noc": lambda v, s: v.annotate_iou_noc(s[0], 0.8765, 4),
    "eval_panel": lambda v, s: v.eval_panel(
        s[0], s[1] > 0, s[2], 0.9, 2, clicks_list=s[3], boxes=s[4],
        scribbles=s[5], prompt_type=1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_vis_matches_jax(name):
    if name in ("annotate_iou_noc", "eval_panel"):
        pytest.importorskip("PIL")
    for seed in (0, 1):
        scene = _scene(seed)
        want = CASES[name](jvis, scene)
        got = CASES[name](tvis, scene)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(9, 13, 3), (1, 1, 3), (6, 5), (48, 64, 3)])
def test_png_round_trips_through_pil(tmp_path, shape):
    Image = pytest.importorskip("PIL.Image")
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                   dtype=np.uint8)
    tvis.write_png(tmp_path / "x.png", a)
    with Image.open(tmp_path / "x.png") as im:
        assert im.format == "PNG" and im.mode == ("RGB" if a.ndim == 3
                                                  else "L")
        np.testing.assert_array_equal(np.asarray(im), a)


def test_png_refuses_other_layouts(tmp_path):
    with pytest.raises(ValueError, match="write_png"):
        tvis.write_png(tmp_path / "x.png", np.zeros((4, 4, 4), np.uint8))
