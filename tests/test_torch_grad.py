"""The training slice's modules vs the JAX package, on the CPU at small
sizes: the attention backward, the LN+MLP and flash backward, the training
rounds' forward (`vpu_forward` with the round's prompt type, against JAX's
traced-type forward) and its parameter gradients, the three losses, the AdaptiveIoU
metric and the training prompt simulation (next click, ed mask, boxes).

The JAX Pallas calls run as the JAX tests run them on the CPU (interpret
mode); the JAX reference calls are jitted. torch cannot reproduce
`jax.random`, so the click Gumbel noise and the box jitter are JAX's own
draws, handed to the port.

Tolerances: f32 gradients 1e-5 relative to the largest entry (the same f32
math summed in another order); the bf16 attention backward 2**-7 relative
to the largest entry (a bf16 rounding of an output that both sides compute
from the same p32, measured 3.9e-3 of it); bf16 LN+MLP gradients 2e-2
relative (the weight gradients sum bf16-rounded products over 96 rows in
another order); the forward 1e-4 as tests/test_torch_model.py, its
parameter gradients 1e-4 relative to the largest; loss values and metrics
1e-6, loss gradients 1e-5 relative; clicks, slots and masks exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.engine import losses as jl, metrics as jm
from pvpuformer_tpu.engine import prompt_sim as jps
from pvpuformer_tpu.models import vpu as jvpu
from pvpuformer_tpu.ops import attention as jattn
from pvpuformer_tpu.ops import fused_attention as jfa, fused_mlp as jfm
from pvpuformer_tpu.utils.serialization import flatten_tree
from pvpuformer_tpu_torch.engine import losses as tl, metrics as tm
from pvpuformer_tpu_torch.engine import prompt_sim as tps
from pvpuformer_tpu_torch.models import vpu as tvpu
from pvpuformer_tpu_torch.ops import attention as tattn
from pvpuformer_tpu_torch.ops import fused_attention as tfa, fused_mlp as tfm
from pvpuformer_tpu_torch.utils.serialization import jax_name
from test_models import tiny_cfg
from test_torch_model import port_model, two_torch_threads  # noqa: F401


def _t(a, dtype=None, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32) if dtype is None
                         or dtype == torch.bfloat16 else np.array(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _rel_close(got, want, rel):
    """max |got - want| <= rel * max(max |want|, 1e-30)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# attention backward (kernel 2's plain version) and the autograd functions
# ---------------------------------------------------------------------------

_j_bwd = jax.jit(jfa._vjp_bwd, static_argnums=0)


@pytest.mark.parametrize("shape", [(2, 49, 2, 32), (2, 2, 16, 2, 16)],
                         ids=["bnhd", "windows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_plain_matches_jax(shape, dtype):
    r = np.random.default_rng(3)
    q, k, v, g = (r.normal(size=shape).astype(np.float32) for _ in range(4))
    scale = shape[-1] ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _j_bwd(scale, tuple(jnp.asarray(x, jdt) for x in (q, k, v)),
                  jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    got = tfa.fused_attention_bwd_plain(*(_t(x, tdt) for x in (q, k, v, g)),
                                        scale)
    # the autograd function's CPU backward is the plain version itself
    qt, kt, vt = (_t(x, tdt, grad=True) for x in (q, k, v))
    auto = torch.autograd.grad(tfa.fused_attention(qt, kt, vt, scale),
                               (qt, kt, vt), _t(g, tdt))
    rel = 1e-5 if dtype == "float32" else 2 ** -7
    for a, b, w in zip(got, auto, want):
        assert a.dtype == tdt
        assert torch.equal(a, b)
        _rel_close(_np(a), np.asarray(w, np.float32), rel)


def test_flash_attention_grads_match_jax():
    r = np.random.default_rng(5)
    q, k, v, g = (r.normal(size=(2, 40, 2, 32)).astype(np.float32)
                  for _ in range(4))
    _, vjp = jax.vjp(lambda *a: jattn.flash_attention(*a),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(x, grad=True) for x in (q, k, v))
    got = torch.autograd.grad(tattn.flash_attention(qt, kt, vt),
                              (qt, kt, vt), _t(g))
    for a, w in zip(got, want):
        _rel_close(_np(a), np.asarray(w), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_grads_match_jax(dtype):
    r = np.random.default_rng(6)
    d, hid = 64, 256
    x = r.normal(size=(2, 48, d)).astype(np.float32)
    leaves = {"scale": r.normal(1, 0.1, d), "bias": r.normal(0, 0.1, d),
              "w1": r.normal(0, 0.05, (d, hid)), "b1": r.normal(0, 0.05, hid),
              "w2": r.normal(0, 0.05, (hid, d)), "b2": r.normal(0, 0.05, d)}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    g = r.normal(size=x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jf(x, lv):
        return jfm.fused_ln_mlp(
            x, {"scale": lv["scale"], "bias": lv["bias"]},
            {"fc1": {"w": lv["w1"], "b": lv["b1"]},
             "fc2": {"w": lv["w2"], "b": lv["b2"]}})

    _, vjp = jax.vjp(jf, jnp.asarray(x, jdt),
                     {k: jnp.asarray(v) for k, v in leaves.items()})
    jgx, jgl = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    xt = _t(x, tdt, grad=True)
    lt = {k: _t(v, grad=True) for k, v in leaves.items()}
    ln = type("LN", (), {"scale": lt["scale"], "bias": lt["bias"]})
    lin = lambda w, b: type("Lin", (), {"w": lt[w], "b": lt[b]})  # noqa: E731
    mlp = type("MLP", (), {"fc1": lin("w1", "b1"), "fc2": lin("w2", "b2")})
    out = tfm.fused_ln_mlp(xt, ln, mlp)
    assert out.dtype == tdt
    got = torch.autograd.grad(out, [xt] + list(lt.values()), _t(g, tdt))
    rel = 1e-5 if dtype == "float32" else 2e-2
    _rel_close(_np(got[0]), np.asarray(jgx, np.float32), rel)
    for name, a in zip(lt, got[1:]):
        _rel_close(_np(a), np.asarray(jgl[name]), rel)


# ---------------------------------------------------------------------------
# the training forward: vpu_forward vs JAX vpu_forward_traced_type
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def jax_tiny_params():
    """JAX `init_vpu` of tiny_cfg() (global blocks), made once per process
    (tests/test_torch_train.py uses it too: the eager init takes ~11 s)."""
    return jvpu.init_vpu(jax.random.key(0), tiny_cfg()), tiny_cfg()


@pytest.fixture(scope="module")
def tiny_models():
    params, jcfg = jax_tiny_params()
    model, cfg = port_model(params, jcfg)
    model.requires_grad_(True)
    return params, jcfg, model, cfg


def _prompt_inputs(seed=0):
    r = np.random.default_rng(seed)
    img = r.uniform(size=(2, 64, 64, 4)).astype(np.float32)
    pts = np.full((2, 12, 3), -1.0, np.float32)
    pts[0, 0] = [20, 30, 0]
    pts[0, 6] = [40, 10, 1]
    pts[1, 0] = [5, 60, 0]
    pts[1, 1] = [33, 33, 2]
    boxes = np.array([[30, 28, 20, 16, 5], [40, 30, 12, 22, 7]], np.float32)
    scr = np.stack([np.stack([np.linspace(10, 50, 30), np.linspace(12, 40, 30)],
                             -1)] * 2).astype(np.float32)
    rects = np.array([[30, 26, 40, 28], [30, 26, 40, 28]], np.float32)
    return img, pts, boxes, scr, rects


def _j_traced_loss(params, cfg, inputs, ptype, r1, r2):
    out = jvpu.vpu_forward_traced_type(params, cfg, *inputs, ptype)
    loss = jnp.sum(out["instances"] * r1) + jnp.sum(out["instances_aux"] * r2)
    return loss, out


# the forward rides along as the aux of its gradient: one compile for both,
# and for all three prompt types (the type is traced)
_j_traced_grad = jax.jit(jax.grad(_j_traced_loss, has_aux=True),
                         static_argnums=1)


@pytest.mark.parametrize("ptype", [0, 1, 2])
def test_forward_traced_type_and_grads_match_jax(tiny_models, ptype):
    params, jcfg, model, cfg = tiny_models
    inputs = _prompt_inputs()
    img, pts, boxes, scr, rects = (_t(x) for x in inputs)
    r = np.random.default_rng(ptype)
    b, h, w, _ = img.shape
    r1 = r.normal(size=(b, h, w, 1)).astype(np.float32)
    r2 = r.normal(size=(b, h, w, pts.shape[1])).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jg, want = _j_traced_grad(params, jcfg,
                                  tuple(jnp.asarray(x) for x in inputs),
                                  jnp.int32(ptype), jnp.asarray(r1),
                                  jnp.asarray(r2))
    got = tvpu.vpu_forward(model, cfg, img, pts, boxes,
                           (scr[:, None], rects[:, None]), ptype)
    for key in ("instances", "instances_aux"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                                   atol=1e-4, rtol=1e-4)

    jg = flatten_tree(jg)
    model.zero_grad()
    loss = (got["instances"] * _t(r1)).sum() + \
        (got["instances_aux"] * _t(r2)).sum()
    loss.backward()
    scale = max(float(np.abs(v).max()) for v in jg.values())
    for name, prm in model.named_parameters():
        want_g = jg[jax_name(name)]
        got_g = np.zeros_like(want_g) if prm.grad is None else _np(prm.grad)
        err = float(np.abs(got_g - want_g).max())
        assert err <= 1e-4 * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs():
    r = np.random.default_rng(7)
    logits = (r.normal(size=(2, 16, 16, 1)) * 3).astype(np.float32)
    label = (r.uniform(size=(2, 16, 16, 1)) > 0.6).astype(np.float32)
    label[0, :2] = -1.0                      # ignored pixels in sample 0
    probs = r.uniform(0.01, 0.99, size=(2, 16, 16, 4)).astype(np.float32)
    ed = r.uniform(size=(2, 16, 16, 4)) > 0.5
    return logits, label, probs, ed


def test_losses_and_grads_match_jax():
    logits, label, probs, ed = _loss_inputs()
    jfns = {
        "nfl": lambda x: jl.normalized_focal_loss(x, jnp.asarray(label),
                                                  alpha=0.5, gamma=2.0),
        "dice": lambda x: jl.dice_loss(x, jnp.asarray(label),
                                       use_sigmoid=True, naive_dice=True),
        "bce": lambda x: jl.sigmoid_bce_loss(
            x, jnp.asarray(ed, jnp.float32), from_sigmoid=True),
    }
    tfns = {
        "nfl": lambda x: tl.normalized_focal_loss(x, _t(label), alpha=0.5,
                                                  gamma=2.0),
        "dice": lambda x: tl.dice_loss(x, _t(label), use_sigmoid=True,
                                       naive_dice=True),
        "bce": lambda x: tl.sigmoid_bce_loss(x, _t(ed.astype(np.float32)),
                                             from_sigmoid=True),
    }
    for name in jfns:
        x = probs if name == "bce" else logits
        wv, vjp = jax.vjp(jfns[name], jnp.asarray(x))
        gw = np.arange(1.0, 3.0, dtype=np.float32)          # (B,) cotangent
        (wg,) = vjp(jnp.asarray(gw))
        xt = _t(x, grad=True)
        v = tfns[name](xt)
        (g,) = torch.autograd.grad(v, xt, _t(gw))
        np.testing.assert_allclose(_np(v), np.asarray(wv), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        _rel_close(_np(g), np.asarray(wg), 1e-5)
    # the NFL diagnostics
    _, jaux = jl.normalized_focal_loss(jnp.asarray(logits), jnp.asarray(label),
                                       with_aux=True)
    _, aux = tl.normalized_focal_loss(_t(logits), _t(label), with_aux=True)
    for key in ("sample_mult", "beta_pmax"):
        np.testing.assert_allclose(_np(aux[key]), np.asarray(jaux[key]),
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_array_equal(aux["no_ignore"].numpy(),
                                  np.asarray(jaux["no_ignore"]))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_adaptive_iou_matches_jax():
    r = np.random.default_rng(8)
    jstate = jm.AdaptiveIoU().device_state()
    host, jhost = tm.AdaptiveIoU(), jm.AdaptiveIoU()
    state = host.device_state()
    for step in range(4):
        logits = r.normal(size=(3, 12, 12, 1)).astype(np.float32)
        gt = (r.uniform(size=(3, 12, 12, 1)) > 0.5).astype(np.float32)
        if step == 2:
            gt[:] = 0.0                         # no valid sample: no update
        gt[0, 0, 0, 0] = -1.0
        jthr = jm.state_thresholds(jstate)
        jious, jvalid = jm.iou_at_thresholds(jnp.asarray(logits),
                                             jnp.asarray(gt), jthr)
        thr = tm.state_thresholds(state)
        np.testing.assert_allclose(thr.numpy(), np.asarray(jthr), rtol=1e-6)
        ious, valid = tm.iou_at_thresholds(_t(logits), _t(gt), thr)
        np.testing.assert_allclose(ious.numpy(), np.asarray(jious), rtol=1e-6)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        jstate = jm.adaptive_iou_step(jstate, jious, jvalid)
        state = tm.adaptive_iou_step(state, ious, valid)
        for a, b in zip(state, jstate):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        host.update(_t(logits), _t(gt))
        jhost.update(logits, gt)
        assert host.iou_thresh == pytest.approx(jhost.iou_thresh, rel=1e-6)
    assert host.get_epoch_value() == pytest.approx(jhost.get_epoch_value(),
                                                   rel=1e-6)
    host.ingest_state(state)
    assert host.get_epoch_value() == pytest.approx(jhost.get_epoch_value(),
                                                   rel=1e-6)


# ---------------------------------------------------------------------------
# training prompt simulation
# ---------------------------------------------------------------------------

def _gumbels(key, b, h, w):
    """next_clicks' draws: one Gumbel map per item of split(key, b)."""
    return np.stack([np.asarray(jax.random.gumbel(k, (h, w)))
                     for k in jax.random.split(key, b)])


def _offsets(key, b):
    """synth_boxes' jitter draws: per item k1..k4 = split(k, 4)."""
    out = []
    for k in jax.random.split(key, b):
        ks = jax.random.split(k, 4)
        out.append([int(jax.random.randint(kk, (), lo, hi)) for kk, lo, hi in
                    zip(ks, (-10, 0, -10, 0), (1, 11, 1, 11))])
    return torch.tensor(out, dtype=torch.int32)


def _click_cases():
    """test_engine.py:98-146's positive, negative and no-error cases, and a
    batch of three overlapping predictions."""
    h = w = 40
    cases = []
    gt = np.zeros((1, h, w), np.float32)
    gt[0, 10:30, 10:30] = 1.0
    cases.append(("positive", np.zeros((1, h, w), np.float32), gt,
                  np.full((1, 8, 3), -1.0, np.float32)))
    pred = np.zeros((1, h, w), np.float32)
    pred[0, 5:25, 5:25] = 1.0
    pts = np.full((1, 8, 3), -1.0, np.float32)
    pts[0, 0] = (7, 7, 0)
    cases.append(("negative", pred, np.zeros((1, h, w), np.float32), pts))
    cases.append(("no_error", np.ones((1, 16, 16), np.float32),
                  np.ones((1, 16, 16), np.float32),
                  np.full((1, 4, 3), -1.0, np.float32)))
    r = np.random.default_rng(9)
    gt = np.zeros((3, h, w), np.float32)
    gt[0, 5:30, 8:20] = 1.0
    gt[1, 12:36, 4:38] = 1.0
    gt[2, 2:10, 2:10] = 1.0
    pred = np.clip(gt + r.normal(0, 0.3, gt.shape), 0, 1).astype(np.float32)
    pred[1, 20:30, 10:30] = 0.0
    pts = np.full((3, 8, 3), -1.0, np.float32)
    pts[:, 0] = (12, 12, 0)
    pts[1, 1] = (20, 20, 1)
    pts[2, 4:] = (3, 3, 2)                    # no free negative slot
    cases.append(("batch", pred, gt, pts))
    return cases


_j_next_clicks = jax.jit(jps.next_clicks)
_j_update_ed = jax.jit(jps.update_ed_mask)
_j_get_next = jax.jit(jps.get_next_prompts, static_argnames=("update_points",))


@pytest.mark.parametrize("case", _click_cases(), ids=lambda c: c[0])
def test_next_clicks_and_ed_mask_match_jax(case):
    name, pred, gt, pts = case
    b, h, w = gt.shape
    key = jax.random.key(11)
    jpts, jinfo = _j_next_clicks(jnp.asarray(pred), jnp.asarray(gt),
                                 jnp.asarray(pts), key)
    got, info = tps.next_clicks(_t(pred), _t(gt), _t(pts),
                                _t(_gumbels(key, b, h, w)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpts))
    for field in info._fields:
        np.testing.assert_array_equal(getattr(info, field).numpy(),
                                      np.asarray(getattr(jinfo, field)),
                                      err_msg=field)
    ed = np.random.default_rng(1).uniform(size=(b, h, w, pts.shape[1])) > 0.5
    np.testing.assert_array_equal(
        tps.update_ed_mask(torch.from_numpy(ed), info).numpy(),
        np.asarray(_j_update_ed(jnp.asarray(ed), jinfo)))
    if name == "no_error":
        assert not info.has_click.any()
        np.testing.assert_array_equal(got.numpy(), pts)
    if name == "negative":
        assert int(info.slot[0]) == 4 and got[0, 4, 2] == 1.0


@pytest.mark.parametrize("update_points", [True, False])
def test_get_next_prompts_matches_jax(update_points):
    _, pred, gt, pts = _click_cases()[-1]
    b, h, w = gt.shape
    ed = np.random.default_rng(2).uniform(size=(b, h, w, 8)) > 0.5
    key = jax.random.key(12)
    want = _j_get_next(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(pts),
                       jnp.asarray(ed), key, update_points=update_points)
    kc, kb = jax.random.split(key)
    got = tps.get_next_prompts(_t(pred), _t(gt), _t(pts), torch.from_numpy(ed),
                               _t(_gumbels(kc, b, h, w)), _offsets(kb, b),
                               update_points=update_points)
    for a, wv in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(wv))
