"""The plain reference against the program's eager path on the CPU at a
tiny f32 configuration: the forward, the EDT oracle, a whole click round
teacher-forced from the program's state, and the benchmark's weight
families against the program's own initialisers."""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, harness, weights
from benchmark.reference import rounds, vpu
from benchmark.tests.tiny import TINY

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    model, specs = harness.build_model(TINY, 1234, torch.device("cpu"))
    P = weights.reference_params(specs, 1234, "cpu", torch.float32)
    return model, P


def test_config_files_build_the_programs_presets():
    """ViT-B is the program's shipped preset; ViT-H is its preset with
    SimpleClick's ViT-H neck and head widths."""
    import dataclasses
    from pvpuformer_tpu_torch.models.vpu import (vpu_base_config,
                                                 vpu_huge_config)
    huge = vpu_huge_config(dtype=torch.bfloat16)
    od = (240, 480, 960, 1920)
    huge = huge.replace(neck=dataclasses.replace(huge.neck, out_dims=od),
                        head=dataclasses.replace(huge.head, in_channels=od))
    for name, want in (("vpu_vitb448", vpu_base_config(dtype=torch.bfloat16)),
                       ("vpu_vith448", huge)):
        cfg = json.loads((ROOT / "benchmark" / "configs"
                          / f"{name}.json").read_text())
        assert harness.vpu_config(cfg) == want


def test_weights_repeat_for_a_seed_and_match_the_program(tiny):
    model, P = tiny
    again = weights.reference_params(weights.specs_of(model), 1234, "cpu",
                                     torch.float32)
    assert all(torch.equal(P[k], again[k]) for k in P)
    for k, v in model.state_dict().items():
        assert torch.equal(v, P[k]), k


def test_weight_families_follow_the_programs_initialisers():
    """Each leaf's family and scale as the program's own init draws it
    (VPUModel with a CPU generator): constants equal, uniform leaves
    inside their bound and reaching most of it, normal leaves at their
    std."""
    from pvpuformer_tpu_torch.models.vpu import VPUModel
    model = VPUModel(harness.vpu_config(TINY), torch.Generator().manual_seed(0))
    shapes = dict(weights.specs_of(model))
    for name, t in model.state_dict().items():
        a, b, c = weights.leaf_init(name, shapes)
        t = t.float()
        if a == b == 0:
            assert torch.all(t == c), name
        elif b:
            assert abs(t.std().item() - b) < 0.35 * b, name
        else:
            bound = -c
            assert t.abs().max() <= bound * (1 + 1e-6), name
            if t.numel() >= 64:
                assert t.abs().max() > 0.8 * bound, name


def test_forward_matches_the_programs_f32_forward(tiny):
    from pvpuformer_tpu_torch.models.vpu import vpu_forward
    model, P = tiny
    g = torch.Generator().manual_seed(3)
    image = torch.rand((2, 64, 64, 4), generator=g)
    points = torch.full((2, 12, 3), -1.0)
    points[:, 0] = torch.tensor([20.0, 30.0, 0.0])
    points[:, 6] = torch.tensor([50.0, 10.0, 1.0])
    points[1, 1] = torch.tensor([5.0, 60.0, 2.0])
    with torch.no_grad():
        want = vpu_forward(model, model.cfg, image, points)["instances"]
    got = vpu.forward(P, TINY, image, points)
    assert got.shape == want.shape
    assert (got - want).abs().max() < 1e-4


def test_bf16_forward_rounds_where_the_program_rounds():
    """In bf16 the reference rounds each op where the program's bf16
    forward does: on the CPU, where both use PyTorch's own products, the
    program's logits lie no farther from it than its own evaluation in
    reverse order of sums does, and the program's int8 path lies far
    beyond that."""
    from pvpuformer_tpu_torch import nn as pnn
    from pvpuformer_tpu_torch.models.vpu import vpu_forward
    cfg = dict(TINY, dtype="bfloat16")
    model, specs = harness.build_model(cfg, 57, torch.device("cpu"))
    P = weights.reference_params(specs, 57, "cpu", torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    image = torch.rand((2, 64, 64, 4), generator=g)
    points = torch.full((2, 12, 3), -1.0)
    points[:, 0] = torch.tensor([20.0, 30.0, 0.0])
    points[:, 6] = torch.tensor([50.0, 10.0, 1.0])
    with torch.no_grad():
        want = vpu_forward(model, model.cfg, image, points)["instances"]
        q8 = pnn.inference_model(model, torch.bfloat16, "cpu", int8=True)
        int8 = vpu_forward(q8, q8.cfg, image, points)["instances"]
    ref = vpu.forward(P, cfg, image, points)
    rev = vpu.forward(P, cfg, image, points, reverse=True)
    floor = (rev - ref).abs().mean()
    assert floor < 2e-3
    assert (want.float() - ref).abs().mean() <= floor
    assert (int8.float() - ref).abs().mean() > max(3 * floor, 1e-3)


def test_edt_matches_the_programs_exactly():
    from pvpuformer_tpu_torch.ops.edt import squared_edt
    g = torch.Generator().manual_seed(4)
    masks = torch.rand((3, 37, 53), generator=g) > 0.3
    masks[1] = True
    got = rounds.squared_edt(masks)
    for i in range(3):
        assert torch.equal(got[i], squared_edt(masks[i]))


def test_a_round_matches_the_programs_round(tiny):
    """Program rounds of two sessions from a fresh state, each held against
    the reference from the program's state before it."""
    from pvpuformer_tpu_torch.inference.predictor import (
        PredictorConfig, batched_click_step, init_session, stack_states)
    model, P = tiny
    cfg = PredictorConfig(model=model.cfg, target_size=(64, 64))
    rng = np.random.default_rng(7)
    states = []
    for h, w in ((70, 50), (64, 60)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        m = np.zeros((h, w), np.float32)
        m[10:40, 15:35] = 1
        states.append(init_session(img, m, 6, (128, 64), "cpu"))
    st = stack_states(states)
    for _ in range(4):
        with torch.no_grad():
            nxt, iou = batched_click_step(model, cfg, st)
        readings = check.compare(P, TINY, check.as_batch(st, False),
                                 check.as_batch(nxt, False), iou)
        ok, checks = check.verdict(readings, {
            "click_off": 0, "roi_off": 0, "iou_gap": 0, "prob_excess": 1e-5})
        assert ok, checks
        st = nxt


def test_the_reference_round_runs_whole(tiny):
    """`rounds.click_round` (oracle, ROI, forward) from a fresh state gives
    the program's click and probabilities."""
    from pvpuformer_tpu_torch.inference.predictor import (
        PredictorConfig, click_step, init_session)
    model, P = tiny
    cfg = PredictorConfig(model=model.cfg, target_size=(64, 64))
    img = np.full((60, 60, 3), 100, np.uint8)
    m = np.zeros((60, 60), np.float32)
    m[5:30, 5:50] = 1
    st = init_session(img, m, 6, (64, 64), "cpu")
    with torch.no_grad():
        nxt, iou = click_step(model, cfg, st)
    ref = rounds.click_round(P, TINY, check.as_batch(st, True))
    assert torch.equal(ref["points"][0], nxt.points[0])
    assert torch.equal(ref["roi"][0], nxt.roi)
    assert (ref["prev_probs"][0] - nxt.prev_probs[0]).abs().max() < 1e-5
    assert math.isclose(float(rounds.iou(ref["gt"], ref["prev_probs"])[0]),
                        float(iou), abs_tol=1e-3)
