"""Caption co-training and the token shuffle in the port against the JAX
package, f32 on the CPU at the tiny config (depth 4, width 64, 64 x 64)
with tests/test_engine.py's text tower, ClipTextConfig(width=32, heads=2,
layers=2, context_length=32, embed_dim=16).

Weights: the JAX `init_vpu` tree (with `clip_text` and `caption_proj`) and
`init_plainvit` tree, read with jax.eval_shape, leaves drawn from a numpy
seed (tests/test_torch_zoo.py:jax_weights). Draws: torch cannot reproduce
`jax.random`, so the port takes JAX's own: the training step's through
tests/test_torch_train.py:jax_train_noise, and the shuffle's as the
successive `jax.random.split` subkeys of the `shuffle_key`, each giving
`uniform(sub, (B, N))`.

Tolerances: forwards within 2e-5 of the jitted JAX forward relative to the
largest logit (tests/test_torch_zoo.py's FWD_TOL); the iterloss loss 1e-5
and every gradient within 1e-5 x max(max |g|, 1) (tests/test_torch_train.py's
bounds), clicks exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvpuformer_tpu.engine import train_step as jts
from pvpuformer_tpu.models import plainvit as jpv, vpu as jvpu
from pvpuformer_tpu.models.zoo.clip_text import ClipTextConfig, byte_tokenizer
from pvpuformer_tpu.utils import serialization as jser
from pvpuformer_tpu_torch.engine import optimizer as topt, train_step as tts
from pvpuformer_tpu_torch.engine import trainer as ttr
from pvpuformer_tpu_torch.models import plainvit as tpv, registry
from pvpuformer_tpu_torch.models import vit as tvit, vpu as tvpu
from pvpuformer_tpu_torch.models.zoo.clip_text import ClipText
from pvpuformer_tpu_torch.utils import serialization as tser
from test_engine import tiny_batch
from test_models import tiny_cfg
from test_torch_plainvit import tiny_plainvit
from test_torch_train import _j_value_and_grad, jax_train_noise
from test_torch_zoo import (FWD_TOL, forward_inputs, jax_weights,
                            port_family, rel_err)
from test_torch_zoo import two_torch_threads  # noqa: F401 (autouse)

TEXT = ClipTextConfig(vocab_size=49408, context_length=32, width=32, heads=2,
                      layers=2, embed_dim=16)
CAPTIONS = ["the left box", "a small square"]


@functools.lru_cache(maxsize=None)
def caption_weights():
    """The text-tower VPU (window_pixels 32: blocks 1-3 windowed, so the
    shuffle mode, global in every block, differs from the plain forward)."""
    jcfg = tiny_cfg(window_pixels=32).replace(text=TEXT)
    return jax_weights(jcfg, seed=3), jcfg


def shuffle_draws(key, depth: int, b: int, n: int) -> np.ndarray:
    """JAX vit_backbone_forward's draws (vit.py:205-208), (depth, B, N)."""
    out = []
    for _ in range(depth):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (b, n))))
    return np.stack(out)


def _captions(b=2, ctx=32):
    return byte_tokenizer(CAPTIONS[:b], ctx)


_j_pv = jax.jit(jpv.plainvit_forward, static_argnums=1)


def test_vpu_forward_with_captions_and_shuffle_matches_jax():
    """One forward with captions (the caption row rides the DMA queries and
    the channel gates; q_out keeps 2N rows) and one with JAX's shuffle
    draws, each against JAX's."""
    params, jcfg = caption_weights()
    model, cfg = port_family(params, jcfg)
    assert isinstance(model.clip_text, ClipText)
    img, pts = forward_inputs()
    caps = _captions()
    key = jax.random.key(9)

    def both(params, img, pts, caps, key):
        return (jvpu.vpu_forward(params, jcfg, img, pts, captions=caps),
                jvpu.vpu_forward(params, jcfg, img, pts, shuffle_key=key))
    jw_cap, jw_shuf = jax.jit(both)(params, jnp.asarray(img),
                                    jnp.asarray(pts), jnp.asarray(caps), key)
    ti, tp = torch.from_numpy(img), torch.from_numpy(pts)
    got = model(ti, tp, captions=torch.from_numpy(caps))
    noise = torch.from_numpy(shuffle_draws(key, 4, 2, 16))
    seen = []
    block_call = tvit.Block.__call__

    def spy(self, x, *a, **kw):
        seen.append(x.detach().clone())
        return block_call(self, x, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvit.Block, "__call__", spy)
        shuf = tvpu.vpu_forward(model, cfg, ti, tp, shuffle_noise=noise)
        plain = tvpu.vpu_forward(model, cfg, ti, tp)
    for g, w in ((got, jw_cap), (shuf, jw_shuf)):
        for k in ("instances", "instances_aux"):
            assert tuple(g[k].shape) == w[k].shape
            assert rel_err(g[k].detach().numpy(), np.asarray(w[k])) <= FWD_TOL
    # the caption changes the output
    assert rel_err(got["instances"].detach().numpy(),
                   plain["instances"].detach().numpy()) > 1e-3
    # the first block takes the tokens in the order of its noise's stable
    # argsort (the tiny config's blocks are all global, so the shuffled and
    # plain outputs agree up to summation order, as JAX's
    # tests/test_models.py:224-239 holds)
    ids = torch.argsort(noise[0], dim=1, stable=True)
    assert not torch.equal(ids, torch.arange(16).expand(2, 16))
    assert torch.equal(seen[0], seen[4].gather(
        1, ids[:, :, None].expand(2, 16, 64)))


def test_plainvit_shuffle_forward_matches_jax():
    jcfg = tiny_plainvit(32).replace(random_split=True)
    params = jax_weights(jcfg, seed=4)
    model, cfg = port_family(params, jcfg)
    assert cfg.random_split
    img, pts = forward_inputs(seed=2)
    key = jax.random.key(11)
    want = _j_pv(params, jcfg, jnp.asarray(img), jnp.asarray(pts),
                 shuffle_key=key)
    noise = torch.from_numpy(shuffle_draws(key, 4, 2, 16))
    got = tpv.plainvit_forward(model, cfg, torch.from_numpy(img),
                               torch.from_numpy(pts), shuffle_noise=noise)
    assert rel_err(got["instances"].detach().numpy(),
                   np.asarray(want["instances"])) <= FWD_TOL
    # random_split alone is inert, as in JAX: no noise, no shuffle
    plain = model(torch.from_numpy(img), torch.from_numpy(pts))
    jplain = _j_pv(params, jcfg, jnp.asarray(img), jnp.asarray(pts))
    assert rel_err(plain["instances"].detach().numpy(),
                   np.asarray(jplain["instances"])) <= FWD_TOL


def test_shuffle_noise_layout():
    """`vit.shuffle_noise`: the host's (depth, B, N) uniforms from a CPU
    generator, the same for the same seed."""
    from pvpuformer_tpu_torch.models.vit import ViTConfig, shuffle_noise
    cfg = ViTConfig(img_size=(64, 64), depth=4)
    a = shuffle_noise(cfg, torch.Generator().manual_seed(0), 3)
    b = shuffle_noise(cfg, torch.Generator().manual_seed(0), 3)
    assert a.shape == (4, 3, 16) and a.device.type == "cpu"
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())


def test_iterloss_grads_with_captions_match_jax():
    """Two rounds (key 5: a box round, then a click round) with captions:
    the loss, the logs, the clicks and every gradient, those of the text
    tower and of caption_proj among them, against JAX's
    `iterloss_value_and_grad`. The text tower runs inside each round's
    forward, so each round's backward reaches it."""
    params, jcfg = caption_weights()
    key = jax.random.key(5)
    batch = tiny_batch(0, b=2)
    batch["captions"] = _captions()
    (jloss, jaux), jgrads = _j_value_and_grad(
        params, jts.TrainConfig(model=jcfg),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, num_iters=2)
    model, mcfg = port_family(params, jcfg)
    cfg = tts.TrainConfig(model=mcfg)
    model.requires_grad_(True)
    noise = jax_train_noise(key, 2, 64, 64, 2)
    assert noise["prompt_types"] == [1, 0]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert tb["captions"].dtype == torch.int32
    loss, aux = tts._iterloss_loop(model, cfg, tb, noise, 2, with_grads=True)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    for k, v in jaux["logs"].items():
        assert float(aux["logs"][k]) == pytest.approx(float(v), abs=1e-5), k
    np.testing.assert_array_equal(aux["points"].numpy(),
                                  np.asarray(jaux["points"]))
    jflat = jser.flatten_tree(jgrads)
    got = {tser.jax_name(n): p.grad for n, p in model.named_parameters()}
    assert set(got) == set(jflat)
    scale = max(1.0, max(float(np.abs(g).max()) for g in jflat.values()))
    for n, g in jflat.items():
        have = np.zeros_like(g) if got[n] is None else got[n].numpy()
        assert float(np.abs(have - g).max()) <= 1e-5 * scale, n
    for prefix in ("clip_text/", "caption_proj/"):
        assert any(float(np.abs(g).max()) > 0 for n, g in jflat.items()
                   if n.startswith(prefix)), prefix


def test_train_step_and_trainer_checkpoint_with_captions(tmp_path,
                                                         monkeypatch):
    """The port's `train_step` updates the text tower (the JAX test's
    check, tests/test_engine.py:253-291), runs without captions, and the
    Trainer's checkpoint of a text-tower model reloads: the config back
    through the header, every leaf through `registry.load`."""
    params, jcfg = caption_weights()
    model, mcfg = port_family(params, jcfg)
    cfg = tts.TrainConfig(model=mcfg)
    tx = topt.make_optimizer(model, "adam", lr=1e-3)
    key = jax.random.key(1)
    monkeypatch.setattr(tts, "_train_noise",
                        lambda c, g, b, h, w, ni: jax_train_noise(
                            key, b, h, w, ni))
    batch = tiny_batch(0, b=2)
    batch["captions"] = _captions()
    before = model.caption_proj.w.detach().clone()
    text_before = model.clip_text.token_embedding.detach().clone()
    thr = torch.tensor([0.4, 0.375, 0.425])
    logs, _, _ = tts.train_step(model, tx, batch, torch.Generator(), thr,
                                cfg=cfg, num_iters=2, device="cpu")
    assert np.isfinite(float(logs["loss"]))
    assert not torch.equal(before, model.caption_proj.w)
    assert not torch.equal(text_before, model.clip_text.token_embedding)
    batch.pop("captions")
    logs, _, _ = tts.train_step(model, tx, batch, torch.Generator(), thr,
                                cfg=cfg, num_iters=1, device="cpu")
    assert np.isfinite(float(logs["loss"]))

    trainer = ttr.Trainer(model, cfg, tx, [], device="cpu",
                          checkpoint_dir=str(tmp_path))
    trainer.save(0)
    flat, got_cfg, _, _ = tser.load_checkpoint(tmp_path / "000.npz")
    assert got_cfg == cfg and got_cfg.model.text == mcfg.text
    back = registry.load(flat, got_cfg.model)
    for n, t in model.state_dict().items():
        assert torch.equal(back.state_dict()[n], t), n


def test_jax_checkpoint_with_text_and_random_split_loads(tmp_path):
    """A file JAX's `save_checkpoint` wrote for a text-tower VPU with
    random_split=True: the port reads the config (ClipTextConfig and
    the flag kept) and loads every leaf strictly."""
    params, jcfg = caption_weights()
    jcfg = jcfg.replace(random_split=True)
    jser.save_checkpoint(tmp_path / "j.npz", params, config=jcfg, step=3)
    flat, cfg, step, _ = tser.load_checkpoint(tmp_path / "j.npz")
    assert step == 3 and cfg.random_split and cfg.text is not None
    assert cfg.text == tser.config_from_dict(jser.config_to_dict(TEXT))
    model = registry.load(flat, cfg)
    want = jser.flatten_tree(params)
    state = model.state_dict()
    assert set(map(tser.jax_name, state)) == set(want)
    for n, t in state.items():
        np.testing.assert_array_equal(t.numpy(), want[tser.jax_name(n)])
