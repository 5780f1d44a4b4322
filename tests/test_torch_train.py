"""The port's training step, optimizer and Trainer vs the JAX package, on the
CPU at the tiny config (depth 4, width 64, 64x64, head dim 32), f32.

torch cannot reproduce `jax.random`: `jax_train_noise` replays JAX
`_iterloss_loop`'s split sequence from the step key and draws each round's
prompt type, click Gumbel noise, box jitter and dropout uniforms with the
same `jax.random` calls, in the layout of the port's `_train_noise`, which
the tests monkeypatch (as tests/test_torch_prompts.py:jax_noise does for
the prompt sessions). Keys 3 and 0 give the prompt types [0] (num_iters 1,
a click round) and [1, 0, 1] (num_iters 3, box rounds and a click round).

The JAX reference is the gradient of JAX `train_step`: its
`iterloss_value_and_grad` (jitted), which returns the grads that
`train_step` hands to the optimizer, the loss, the logs and the click
tensors. Tolerances: loss 1e-5; every grad within 1e-5 x max(max |g|, 1)
(the JAX test's own bound for the same math summed in another order);
click tensors exact; optimizer parameters 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pvpuformer_tpu import data as jdata
from pvpuformer_tpu.data import transforms as jT
from pvpuformer_tpu.engine import optimizer as jopt, train_step as jts
from pvpuformer_tpu.engine import trainer as jtr
from pvpuformer_tpu.parallel import make_mesh
from pvpuformer_tpu.utils import serialization as jser
from pvpuformer_tpu_torch import data as tdata, nn as tnn
from pvpuformer_tpu_torch.data import transforms as tT
from pvpuformer_tpu_torch.engine import optimizer as topt, train_step as tts
from pvpuformer_tpu_torch.engine import trainer as ttr
from pvpuformer_tpu_torch.models import vit as tvit
from pvpuformer_tpu_torch.utils import serialization as tser
from test_engine import tiny_batch
from test_models import tiny_cfg
from test_torch_grad import jax_tiny_params
from test_torch_model import port_model

THR = np.array([0.4, 0.375, 0.425], np.float32)


def _box_offsets(kb, b):
    """synth_boxes' jitter: per item k1..k4 = split(k, 4), four randints."""
    out = []
    for k in jax.random.split(kb, b):
        ks = jax.random.split(k, 4)
        out.append([int(jax.random.randint(kk, (), lo, hi)) for kk, lo, hi in
                    zip(ks, (-10, 0, -10, 0), (1, 11, 1, 11))])
    return out


def _gumbels(key, b, h, w):
    """next_clicks' draws: one Gumbel map per item of split(key, b)."""
    return np.stack([np.asarray(jax.random.gumbel(kk, (h, w)))
                     for kk in jax.random.split(key, b)])


def jax_train_noise(key, b, h, w, num_iters, use_iterloss=True,
                    use_random_clicks=True):
    """JAX `_iterloss_loop`'s draws from the step key (train_step.py:165-264,
    the itermask branch at :307-318), in the port's `_train_noise` layout."""
    types, gumbels, offsets, drops = [], [], [], []
    extra = {}
    if not use_random_clicks:
        key, k0 = jax.random.split(key)
        extra["init_gumbel"] = torch.from_numpy(_gumbels(k0, b, h, w))
    if not use_iterloss:
        for _ in range(num_iters):
            key, _, kn = jax.random.split(key, 3)
            gumbels.append(_gumbels(kn, b, h, w))
        num_iters = 0                   # no prompt types, jitter or dropout
    for k in range(num_iters):
        key, kp, kt, kd = jax.random.split(key, 4)
        if k == 0:
            types.append(int(jax.random.randint(kt, (), 0, 2)))
            _, kb = jax.random.split(kp)        # get_next_prompts' kc, kb
            offsets.append(_box_offsets(kb, b))
        if k < num_iters - 1:
            drops.append(np.asarray(jax.random.uniform(kd, (b, 1, 1, 1)))
                         .reshape(b))
            key, kn, kb, ktn = jax.random.split(key, 4)
            types.append(int(jax.random.randint(ktn, (), 0, 2)))
            gumbels.append(_gumbels(kn, b, h, w))
            offsets.append(_box_offsets(kb, b))
    return {**extra, "prompt_types": types,
            "gumbel": torch.from_numpy(np.asarray(gumbels, np.float32)
                                       .reshape(-1, b, h, w)),
            "box_offsets": torch.tensor(offsets, dtype=torch.int32)
            .reshape(-1, b, 4),
            "drop_u": torch.from_numpy(np.asarray(drops, np.float32)
                                       .reshape(-1, b))}


def _jax_noise_from(key):
    return lambda cfg, gen, b, h, w, num_iters: jax_train_noise(
        key, b, h, w, num_iters, cfg.use_iterloss, cfg.use_random_clicks)


_j_value_and_grad = jax.jit(jts.iterloss_value_and_grad,
                            static_argnames=("cfg", "num_iters"))


def _port(params, jcfg, **train_kw):
    model, mcfg = port_model(params, jcfg)
    return model, tts.TrainConfig(model=mcfg, **train_kw)


def _grads(model):
    return {tser.jax_name(n): (torch.zeros_like(p) if p.grad is None
                               else p.grad.clone())
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("num_iters,seed,drop", [(1, 3, 0.0), (3, 0, 0.5)])
def test_train_step_matches_jax(monkeypatch, num_iters, seed, drop):
    """num_iters 3 also drops prev masks (prev_mask_drop_prob 0.5: key 0's
    uniforms drop sample 0's mask after rounds 0 and 1, keep sample 1's)."""
    params, jcfg = jax_tiny_params()
    key = jax.random.key(seed)
    batch = tiny_batch(0, b=2)
    (jloss, jaux), jgrads = _j_value_and_grad(
        params, jts.TrainConfig(model=jcfg, prev_mask_drop_prob=drop),
        {k: jnp.asarray(v) for k, v in batch.items()}, key,
        num_iters=num_iters)

    model, cfg = _port(params, jcfg, prev_mask_drop_prob=drop)
    tx = topt.make_optimizer(model, "adam", lr=5e-5)
    monkeypatch.setattr(tts, "_train_noise", _jax_noise_from(key))
    seen = {}
    loop = tts._iterloss_loop

    def spy_loop(*a, **kw):
        seen["out"] = loop(*a, **kw)
        return seen["out"]

    step = tx.step

    def spy_step():
        seen["grads"] = _grads(model)
        return step()

    monkeypatch.setattr(tts, "_iterloss_loop", spy_loop)
    monkeypatch.setattr(tx, "step", spy_step)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    logs, ious, valid = tts.train_step(model, tx, batch, torch.Generator(),
                                       torch.from_numpy(THR), cfg=cfg,
                                       num_iters=num_iters, device="cpu")
    loss, aux = seen["out"]
    if num_iters == 3:          # the box branch ran (types [1, 0, 1])
        assert jax_train_noise(key, 2, 64, 64, 3)["prompt_types"] == [1, 0, 1]
    np.testing.assert_array_equal(aux["points"].numpy(),
                                  np.asarray(jaux["points"]))
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    assert set(logs) == set(jaux["logs"])
    for k, v in jaux["logs"].items():
        assert float(logs[k]) == pytest.approx(float(v), abs=1e-5), k
    jflat = jser.flatten_tree(jgrads)
    assert set(jflat) == set(seen["grads"])
    scale = max(float(np.abs(g).max()) for g in jflat.values())
    worst = max(float(np.abs(seen["grads"][n].numpy() - g).max())
                for n, g in jflat.items())
    assert worst <= 1e-5 * max(scale, 1.0), (worst, scale)
    # the metric inputs, and the update applied in place
    assert ious.shape == (3, 2) and valid.shape == (2,)
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    assert all(p.grad is None for p in model.parameters())


_j_eval_step = jax.jit(jts.eval_step, static_argnames=("cfg", "num_iters"))


def test_itermask_eval_step_matches_jax(monkeypatch):
    """eval_step (no update) through the RITM iter-mask branch, with the
    sampler's clicks replaced by an error-mask click (use_random_clicks
    False): logs and metric IoUs as JAX's."""
    params, jcfg = jax_tiny_params()
    key = jax.random.key(1)
    batch = tiny_batch(1, b=2)
    variant = dict(use_iterloss=False, use_random_clicks=False)
    jlogs, jious, jvalid = _j_eval_step(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        jnp.asarray(THR), cfg=jts.TrainConfig(model=jcfg, **variant),
        num_iters=2)
    model, cfg = _port(params, jcfg, **variant)
    monkeypatch.setattr(tts, "_train_noise", _jax_noise_from(key))
    logs, ious, valid = tts.eval_step(model, batch, torch.Generator(),
                                      torch.from_numpy(THR), cfg=cfg,
                                      num_iters=2, device="cpu")
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        assert float(logs[k]) == pytest.approx(float(v), abs=1e-5), k
    np.testing.assert_allclose(ious.numpy(), np.asarray(jious), atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_per_round_grads_match_joint_backward():
    """The analogue of tests/test_engine.py's test: summing each round's
    backward equals the backward of the summed loss (no gradient crosses
    rounds), here with a box round among the three."""
    params, jcfg = jax_tiny_params()
    batch = tts._place(tiny_batch(0, b=2), torch.device("cpu"))
    noise = jax_train_noise(jax.random.key(0), 2, 64, 64, 3)
    for ni in (1, 3):
        model, cfg = _port(params, jcfg)
        model.requires_grad_(True)
        total, aux1 = tts.iterloss_forward(model, cfg, batch, noise, ni)
        total.backward()
        g1 = _grads(model)
        model.zero_grad()
        total2, aux2 = tts._iterloss_loop(model, cfg, batch, noise, ni,
                                          with_grads=True)
        g2 = _grads(model)
        assert float(total.detach()) == pytest.approx(float(total2), abs=1e-5)
        scale = max(float(g.abs().max()) for g in g1.values())
        worst = max(float((g1[n] - g2[n]).abs().max()) for n in g1)
        assert worst <= 1e-5 * max(scale, 1.0), (worst, scale)
        np.testing.assert_allclose(aux1["final_instances"].numpy(),
                                   aux2["final_instances"].numpy(), atol=1e-5)
        assert set(aux1["logs"]) == set(aux2["logs"])


def test_bf16_train_step_keeps_bf16_attention(monkeypatch):
    """The analogue of test_train_step_attention_stays_bf16: every attention
    call of a bf16 train step (ViT blocks and the DMA neck) sees bf16 q."""
    params, jcfg = jax_tiny_params()
    model, cfg = _port(params, jcfg)
    cfg = dataclasses.replace(cfg, model=cfg.model.replace(
        dtype=torch.bfloat16))
    seen = []

    def spy(fn):
        def wrapped(q, *a, **kw):
            seen.append(q.dtype)
            return fn(q, *a, **kw)
        return wrapped

    monkeypatch.setattr(tvit, "fused_attention", spy(tvit.fused_attention))
    monkeypatch.setattr(tnn, "sdpa", spy(tnn.sdpa))
    monkeypatch.setattr(tts, "_train_noise",
                        _jax_noise_from(jax.random.key(0)))
    tx = topt.make_optimizer(model, "adam", lr=5e-5)
    logs, _, _ = tts.train_step(model, tx, tiny_batch(0, b=2),
                                torch.Generator(), torch.from_numpy(THR),
                                cfg=cfg, num_iters=2, device="cpu")
    assert np.isfinite(float(logs["loss"]))
    assert seen and all(d == torch.bfloat16 for d in seen), set(seen)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

# case -> (make_optimizer kwargs, accumulation steps, on the tiny model):
# only the layer-wise scales need the model's parameter names
OPT_CASES = {
    "adam_milestones": (dict(opt_name="adam", lr=1e-3, milestones=(1, 2),
                             gamma=0.1, steps_per_epoch=2), 1, False),
    "layerwise_decay": (dict(opt_name="adam", lr=1e-3, layerwise_decay=True,
                             weight_decay=0.02), 1, True),
    "accumulate_2": (dict(opt_name="adam", lr=1e-3), 2, False),
}


class _Pair(torch.nn.Module):
    """Two leaves: the optax update's jit over the whole tiny model compiles
    for ~8 s (~17 s with optax.MultiSteps), over two leaves in ~1 s."""

    def __init__(self):
        super().__init__()
        r = np.random.default_rng(1)
        self.w = torch.nn.Parameter(torch.from_numpy(
            r.normal(size=(3, 4)).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.from_numpy(
            r.normal(size=4).astype(np.float32)))


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_make_optimizer_matches_optax(case):
    kw, every, on_model = OPT_CASES[case]
    if on_model:
        model, _ = _port(*jax_tiny_params())
        params = jax_tiny_params()[0]
    else:
        model = _Pair()
        # a copy: jnp.asarray may alias the numpy view of the parameter,
        # which the torch step then updates in place
        params = {n: jnp.array(p.detach().numpy(), copy=True)
                  for n, p in model.named_parameters()}
    tx = topt.with_grad_accumulation(topt.make_optimizer(model, **kw), every)
    jtx = jopt.with_grad_accumulation(jopt.make_optimizer(params, **kw),
                                      every)
    jstate = jtx.init(params)
    jupdate = jax.jit(jtx.update)
    r = np.random.default_rng(4)
    names = {tser.jax_name(n): p for n, p in model.named_parameters()}
    jp = params
    for _ in range(5 * every):
        flat = {n: (r.normal(size=p.shape) * 0.1).astype(np.float32)
                for n, p in names.items()}
        for n, p in names.items():
            p.grad = torch.from_numpy(np.asarray(flat[n]))
        tx.step()
        jg = jser.unflatten_tree(flat)
        upd, jstate = jupdate(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    assert tx.updates == 5
    jflat = jser.flatten_tree(jp)
    for n, p in names.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], atol=1e-6,
                                   rtol=0, err_msg=n)


# ---------------------------------------------------------------------------
# Trainer, checkpoints, entry points
# ---------------------------------------------------------------------------

class _Loader:
    """A tiny in-memory loader: the same `n` numpy batches every epoch."""

    def __init__(self, n, b=2):
        self.batches = [tiny_batch(i, b=b) for i in range(n)]
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        return iter(self.batches)


def _trainer(params, jcfg, loader, tmp=None, **cfg_kw):
    model, cfg = _port(params, jcfg, **cfg_kw)
    tx = topt.make_optimizer(model, "adam", lr=1e-3)
    return ttr.Trainer(model, cfg, tx, loader, device="cpu",
                       checkpoint_dir=tmp, checkpoint_interval=1, seed=5)


def test_trainer_matches_jax_schedule_and_resumes(tmp_path, monkeypatch):
    params, jcfg = jax_tiny_params()
    # JAX's Trainer, its step stubbed: the num_iters it asks for
    jseq = []

    def stub(params, opt_state, batch, key, thr, *, cfg, tx, num_iters):
        jseq.append(num_iters)
        b = batch["image"].shape[0]
        return (params, opt_state, {"loss": jnp.float32(0.0)},
                jnp.zeros((3, b)), jnp.zeros((b,), bool))

    monkeypatch.setattr(jtr, "train_step", stub)
    jtrainer = jtr.Trainer(params, jts.TrainConfig(model=jcfg),
                           jopt.make_optimizer(params, "adam", lr=1e-3),
                           _Loader(3), mesh=make_mesh(1), seed=5)
    for epoch in range(2):
        jtrainer.training(epoch)

    seq = []
    step = ttr.train_step

    def rec(*a, **kw):
        seq.append(kw["num_iters"])
        return step(*a, **kw)

    monkeypatch.setattr(ttr, "train_step", rec)
    full = _trainer(params, jcfg, _Loader(3))
    full.val_loader = _Loader(1)
    full.run(2, validation=True)
    assert seq == jseq and len(seq) == 6
    assert full.global_step == 6
    val = full.validation(1)
    assert np.isfinite(val["loss"]) and 0.0 <= val["AdaptiveIoU"] <= 1.0

    # save after epoch 0, resume in a fresh trainer: bit-identical epoch 1
    first = _trainer(params, jcfg, _Loader(3), str(tmp_path))
    first.run(1)
    resumed = _trainer(params, jcfg, _Loader(3), str(tmp_path))
    assert resumed.resume(tmp_path / "last_checkpoint.npz") == 1
    resumed.run(2)
    for (n, a), b in zip(full.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), n

    # JAX's reader takes the port's file: params and config
    jparams, jconf, step, extra = jser.load_checkpoint(
        tmp_path / "last_checkpoint.npz")
    assert step == 6 and extra["epoch"] == 1
    assert jconf == jts.TrainConfig(model=jcfg)
    jflat = jser.flatten_tree(jparams)
    state = resumed.model.state_dict()
    assert set(jflat) == {tser.jax_name(n) for n in state}
    for n, t in state.items():
        np.testing.assert_array_equal(jflat[tser.jax_name(n)], t.numpy())


def test_trainer_overfits_one_batch():
    params, jcfg = jax_tiny_params()
    loader = _Loader(1)
    tr = _trainer(params, jcfg, loader, max_num_next_clicks=1)
    losses = [tr.training(e)["loss"] for e in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert loader.epochs == list(range(6))


def test_jax_trainer_checkpoint_loads_in_the_port(tmp_path):
    """A file written by JAX `save_checkpoint` with a TrainConfig header (what
    JAX `Trainer.save` writes) loads in the port: config and every leaf."""
    params, jcfg = jax_tiny_params()
    jser.save_checkpoint(tmp_path / "j.npz", params,
                         config=jts.TrainConfig(model=jcfg), step=7,
                         extra={"epoch": 2})
    flat, cfg, step, extra = tser.load_checkpoint(tmp_path / "j.npz",
                                                  opt_state=True)
    assert isinstance(cfg, tts.TrainConfig) and (step, extra["epoch"]) == (7, 2)
    assert cfg == tts.TrainConfig(model=port_model(params, jcfg)[1])
    assert extra["opt_state"] == {}
    want = jser.flatten_tree(params)
    assert set(flat) == set(want)
    for n, a in want.items():
        np.testing.assert_array_equal(flat[n], a)


def test_training_entry_points_default_to_the_card(monkeypatch):
    """Without a card, train_step and Trainer raise unless device="cpu"."""
    params, jcfg = jax_tiny_params()
    model, cfg = _port(params, jcfg)
    tx = topt.make_optimizer(model, "adam", lr=1e-3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tts.train_step(model, tx, tiny_batch(0, b=2), torch.Generator(),
                       torch.from_numpy(THR), cfg=cfg, num_iters=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttr.Trainer(model, cfg, tx, _Loader(1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttr.Trainer(model, cfg, tx, _Loader(1), image_dump_interval=1)


# ---------------------------------------------------------------------------
# the Trainer fed by the data pipeline; the image dump
# ---------------------------------------------------------------------------

def _synthetic_loaders(seed=5):
    """The JAX and the port Loader over the same synthetic records, in the
    tiny batch's shapes (batch 2, 64 x 64, 6 points, 50 scribble samples)."""
    out = []
    for data, T in ((jdata, jT), (tdata, tT)):
        ds = data.SyntheticTrainDataset(
            n_samples=4, hw=(72, 80), epoch_len=4, keep_background_prob=0.0,
            num_scribble_samples=50, augmentator=T.train_augmentator((64, 64)),
            points_sampler=data.MultiPointSampler(6, prob_gamma=0.8))
        out.append(data.Loader(ds, 2, seed=seed, num_workers=2))
    return out


def test_loader_fed_trainer_matches_jax(monkeypatch):
    """The port's Trainer on the port's Loader against the JAX Trainer on
    JAX's Loader, 2 epochs of 2 steps: the same batches, num_iters and step
    keys (the JAX Trainer's step stubbed to record them); then each step's
    loss against JAX's `iterloss_value_and_grad` on that batch and key,
    with JAX's draws injected and plain SGD applied to JAX's gradients on
    the JAX side (loss 1e-5, parameters 1e-6, this file's tolerances). The
    Trainer seed draws num_iters 1 for every step, the jitted JAX reference
    compiled above (num_iters 1, prev_mask_drop_prob 0)."""
    import random

    def draws(s, epoch):
        r = random.Random(f"{s}-{epoch}")
        return [r.randint(1, 3) for _ in range(2)]

    seed = next(s for s in range(1000) if draws(s, 0) == draws(s, 1) == [1, 1])
    params, jcfg = jax_tiny_params()
    jloader, tloader = _synthetic_loaders()
    jrec = []

    def stub(params, opt_state, batch, key, thr, *, cfg, tx, num_iters):
        jrec.append(({k: np.asarray(v) for k, v in batch.items()}, num_iters,
                     jax.random.key_data(key)))
        b = batch["image"].shape[0]
        return (params, opt_state, {"loss": jnp.float32(0.0)},
                jnp.zeros((3, b)), jnp.zeros((b,), bool))

    monkeypatch.setattr(jtr, "train_step", stub)
    jtrainer = jtr.Trainer(params, jts.TrainConfig(model=jcfg),
                           jopt.make_optimizer(params, "sgd", lr=1e-2,
                                               momentum=0.0),
                           jloader, mesh=make_mesh(1), seed=seed)
    for epoch in range(2):
        jtrainer.training(epoch)

    model, cfg = _port(params, jcfg)
    tx = topt.make_optimizer(model, "sgd", lr=1e-2, momentum=0.0)
    monkeypatch.setattr(tts, "_train_noise", lambda cfg, gen, b, h, w, n:
                        jax_train_noise(jax.random.key(gen.initial_seed()),
                                        b, h, w, n))
    trec = []
    step = ttr.train_step

    def rec(model, tx, batch, gen, thr, **kw):
        out = step(model, tx, batch, gen, thr, **kw)
        trec.append((batch, kw["num_iters"], gen.initial_seed(),
                     float(out[0]["loss"])))
        return out

    monkeypatch.setattr(ttr, "train_step", rec)
    ttr.Trainer(model, cfg, tx, tloader, device="cpu", seed=seed).run(2)

    assert len(trec) == len(jrec) == 4
    jp = params
    for (tb, tn, tseed, tloss), (jb, jn, jkey) in zip(trec, jrec):
        assert tb.keys() == jb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tn == jn == 1
        np.testing.assert_array_equal(jax.random.key_data(
            jax.random.key(tseed)), jkey)
        (jloss, _), jg = _j_value_and_grad(
            jp, jts.TrainConfig(model=jcfg),
            {k: jnp.asarray(v) for k, v in jb.items()},
            jax.random.key(tseed), num_iters=1)
        assert tloss == pytest.approx(float(jloss), abs=1e-5)
        jp = jax.tree_util.tree_map(lambda a, g: a - 1e-2 * g, jp, jg)
    jflat = jser.flatten_tree(jp)
    for n, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), jflat[tser.jax_name(n)],
                                   atol=1e-6, rtol=0, err_msg=n)


def test_dump_panel_equals_jax(tmp_path, monkeypatch):
    """The Trainer's image dump: the port's panel is the JAX Trainer's
    `_dump_visualization` array (captured at PIL.Image.fromarray) for the
    same weights and Loader batch, and the PNG written holds it."""
    PIL_Image = pytest.importorskip("PIL.Image")
    params, jcfg = jax_tiny_params()
    jloader, tloader = _synthetic_loaders()
    batch = next(iter(tloader))
    jtrainer = jtr.Trainer(params, jts.TrainConfig(model=jcfg),
                           jopt.make_optimizer(params, "adam", lr=1e-3),
                           jloader, mesh=make_mesh(1),
                           vis_dir=str(tmp_path / "jax"))
    seen = []
    fromarray = PIL_Image.fromarray
    monkeypatch.setattr(PIL_Image, "fromarray",
                        lambda a, *x: seen.append(np.array(a))
                        or fromarray(a, *x))
    jtrainer._dump_visualization(batch)
    assert len(seen) == 1
    model, cfg = _port(params, jcfg)
    trainer = ttr.Trainer(model, cfg, topt.make_optimizer(model, "adam"),
                          tloader, device="cpu", vis_dir=str(tmp_path / "t"),
                          image_dump_interval=1)
    panel = trainer.dump_panel(batch)
    assert panel.shape == (128, 192, 3) and panel.dtype == np.uint8
    np.testing.assert_array_equal(panel, seen[0])
    trainer.global_step = 7
    trainer._dump_visualization(batch)
    with PIL_Image.open(tmp_path / "t" / "000007.png") as im:
        np.testing.assert_array_equal(np.asarray(im), panel)
