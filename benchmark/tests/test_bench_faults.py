"""`correct` comes out false when the timed path is broken underneath:
the tiny cells driven through the harness on the CPU (the card's look
skipped) with the program's round replaced by a faulty one. Faults: a
round that returns its state unchanged; half of the batch's sessions left
out; an answer altered where it is produced (the IoU, the click). There
is no exchange between chips in a one-chip cell."""
from __future__ import annotations

import pytest
import torch

from benchmark.tests.tiny import run_cell, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _unchanged(real):
    def step(model, cfg, states, noise):
        from pvpuformer_tpu_torch.inference import predictor
        return states, predictor._iou(cfg, states, states.prev_probs)
    return step


def _half(real):
    def step(model, cfg, states, noise):
        out, iou = real(model, cfg, states, noise)
        b = states.gt.shape[0]
        keep = torch.arange(b) < max(1, b // 2)
        fields = []
        for name, new, old in zip(out._fields, out, states):
            k = keep.view((-1,) + (1,) * (new.dim() - 1))
            fields.append(torch.where(k, new, old))
        return type(out)(*fields), torch.where(keep, iou, 0.0)
    return step


def _iou_off(real):
    def step(model, cfg, states, noise):
        out, iou = real(model, cfg, states, noise)
        return out, iou + 0.01
    return step


def _click_moved(real):
    def step(model, cfg, states, noise):
        out, iou = real(model, cfg, states, noise)
        pts = out.points.clone()
        last = pts[..., 2] == (out.click_count - 1).view(-1, 1).float()
        pts[..., 0] = torch.where(last, (pts[..., 0] + 1).clamp(max=30),
                                  pts[..., 0])
        return out._replace(points=pts), iou
    return step


def test_a_sound_run_is_correct(root):
    for cell in ("tiny_click", "tiny_noc"):
        assert run_cell(root, cell, seconds=0.2)[0]["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny_click", _unchanged), ("tiny_noc", _unchanged),
    ("tiny_noc", _half),
    ("tiny_click", _iou_off), ("tiny_noc", _iou_off),
    ("tiny_click", _click_moved), ("tiny_noc", _click_moved)])
def test_a_broken_round_is_not_correct(root, monkeypatch, cell, fault):
    from pvpuformer_tpu_torch.inference import predictor
    monkeypatch.setattr(predictor, "_click_step",
                        fault(predictor._click_step))
    result, checks, _ = run_cell(root, cell, seconds=0.2)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("cell", ["tiny_click", "tiny_noc"])
def test_the_control_is_not_correct(root, cell):
    """The control at a size a test run holds: the program's own int8 path
    in place of the f32 program."""
    from benchmark import control
    dev = torch.device("cpu")
    r = control.readings(cell, 9, 0.2, "int8", dev, root)
    assert r["correct"] is False and r["prob_excess"] > 1e-4, r
    assert control.readings(cell, 9, 0.2, "program", dev, root)["correct"]
