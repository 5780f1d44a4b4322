"""The port's tensor parallelism (parallel/tp.py, `shard_params`' "tp" and
"tp+fsdp", the split block of models/vit.py, `fused_ln_mlp_tp`) against the
JAX package and against its own one process, on the CPU at the tiny config
(embed 64, 2 heads, depth 4, 64 x 64), f32.

The reference is JAX's train step (`iterloss_value_and_grad`, the optax
update), jitted once, on a (2, 2) ("data", "model") mesh of conftest's CPU
devices with `shard_params(..., "tp+fsdp")`, traced under
`activation_sharding`, over tests/test_torch_parallel.py's global batches
(batch 8, num_iters 2, JAX's draws of keys 0-2 injected). Against it the
port runs, through tests/torch_parallel_worker.py, "tp" on 2 gloo ranks,
mesh (1, 2), and "tp+fsdp" on 4, mesh (2, 2); both worker sets start once,
together, while the JAX step compiles. The bounds are
tests/test_torch_parallel.py's: losses LOSS_TOL, clicks exact,
the L1 parameter checksum rtol 1e-5, the gathered checkpoint against the
one-process port within MOMENT_ATOL / PARAM_ATOL (the key projections'
biases within lr x steps).
"""
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pvpuformer_tpu.engine import optimizer as jopt, train_step as jts
from pvpuformer_tpu.models import vpu as jvpu
from pvpuformer_tpu.parallel import mesh as jmesh
from pvpuformer_tpu.utils import serialization as jser
from pvpuformer_tpu_torch.engine import optimizer as topt, train_step as tts
from pvpuformer_tpu_torch.models import registry
from pvpuformer_tpu_torch.ops import fused_mlp
from pvpuformer_tpu_torch.parallel import mesh as tmesh, tp as ttp
from pvpuformer_tpu_torch.utils import serialization as tser

import torch_parallel_worker as TW
from test_torch_grad import jax_tiny_params
from test_torch_parallel import (LOSS_TOL, LR, MOMENT_ATOL, PARAM_ATOL,
                                 TINY, WORKER, REPO, _env, _key_bias_rows,
                                 free_port, run_children, torchrun,
                                 write_inputs)

WORLDS = {"tp": 2, "tp+fsdp": 4}      # mode -> ranks; M = 2 in both
# Adam's first step moves a leaf by lr * g / (|g| + eps), eps = 1e-8: an
# element whose gradient at some step is within ten eps of zero moves by its
# gradient's rounding noise (a few 1e-9 here, ~1e-7 of its leaf's largest
# gradient) amplified up to lr / eps; measured: block 0's fc2.w[50, 20],
# gradient -1.093e-8 in one process and -0.949e-8 under "tp", parts by
# 3.53e-5; 10 elements of 546899 (4 of them neck q / k weights) part by
# more than PARAM_ATOL, up to 7.0e-5, all such. These elements (those of
# the one-process run, recorded at every step) are held, as the key
# projections' biases are, to lr x steps, and those that part by more than
# PARAM_ATOL to at most 1e-4 of the elements
EPS_REGIME = 1e-7


def _jax_step(params, opt_state, batch, key, *, cfg, tx, num_iters):
    (loss, aux), grads = jts.iterloss_value_and_grad(params, cfg, batch, key,
                                                     num_iters)
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, \
        aux["points"]


def jax_reference(batches):
    """(losses, clicks per step, checksum, compiles) of JAX's step on a
    (2, 2) tp+fsdp mesh: parameters by `shard_params(..., "tp+fsdp")`, the
    Adam state placed like them (in and out: one compile), the batch over
    "data"."""
    params, jcfg = jax_tiny_params()
    cfg = jts.TrainConfig(model=jcfg)
    tx = jopt.make_optimizer(params, "adam", lr=LR, milestones=(190, 210),
                             gamma=0.1, steps_per_epoch=10)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    params = jmesh.shard_params(params, mesh, "tp+fsdp")
    opt_state = jax.jit(tx.init)(params)
    repl = NamedSharding(mesh, P())
    placed = jax.tree_util.tree_map(
        lambda x: x.sharding if isinstance(x.sharding, NamedSharding)
        else repl, (params, opt_state))
    params, opt_state = jax.device_put((params, opt_state), placed)
    rows = NamedSharding(mesh, P("data"))
    step = jax.jit(functools.partial(_jax_step, cfg=cfg, tx=tx,
                                     num_iters=TW.NUM_ITERS),
                   out_shardings=(*placed, None, None))
    losses, clicks = [], []
    with mesh, jmesh.activation_sharding(mesh):
        for s, batch in enumerate(batches):
            gb = {k: jax.device_put(jnp.asarray(v), rows)
                  for k, v in batch.items()}
            params, opt_state, loss, pts = step(params, opt_state, gb,
                                                jax.random.key(s))
            losses.append(float(loss))
            clicks.append(np.asarray(pts))
    checksum = float(sum(jnp.sum(jnp.abs(leaf.astype(jnp.float32)))
                         for leaf in jax.tree_util.tree_leaves(params)))
    return losses, clicks, checksum, step._cache_size()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)                # as each rank
    try:
        yield _runs(tmp_path_factory.mktemp("tensor_parallel"))
    finally:
        torch.set_num_threads(threads)


def _runs(work):
    batches = write_inputs(work)
    orig, step = tts._train_noise, topt.TrainOptimizer.step
    tts._train_noise = TW.step_noise(work)
    small = {}                  # param index -> |gradient| < EPS_REGIME

    def spy(tx):
        for i, p in enumerate(tx.params):
            g = (p.grad if p.grad is not None else torch.zeros_like(p)).abs()
            small[i] = small.get(i, False) | (g < EPS_REGIME)
        return step(tx)
    topt.TrainOptimizer.step = spy
    try:
        model, mcfg = TW.tiny_model(work)
        single, s_losses, s_clicks, _, _ = TW.train(
            model, mcfg, None, "replicated", batches, work / "single")
        single.save(0)
    finally:
        tts._train_noise, topt.TrainOptimizer.step = orig, step
    names = [tser.jax_name(n) for n, _ in single.model.named_parameters()]
    small = {names[i]: m.numpy() for i, m in small.items()}
    # both worker sets at once, the JAX step compiling meanwhile
    cmds, envs = [], []
    for mode, world in WORLDS.items():
        port = free_port()
        for r in range(world):
            cmds.append([sys.executable, str(WORKER), "--work", str(work),
                         "--model-parallel", "2"])
            envs.append(_env(RANK=str(r), WORLD_SIZE=str(world),
                             LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=str(port)))
    procs = run_children(cmds, REPO, envs, wait=False)
    jax_ref = jax_reference(batches)
    for rc, out, err in procs():
        assert rc == 0, (out[-2000:], err[-4000:])
    ranks = {mode: [json.loads((work / f"{mode}_rank{r}.json").read_text())
                    for r in range(world)]
             for mode, world in WORLDS.items()}
    return {"work": work, "ranks": ranks, "jax": jax_ref, "small": small,
            "single": (s_losses, s_clicks,
                       TW.checksum(single.model.state_dict()))}


@pytest.mark.parametrize("mode", list(WORLDS))
def test_tensor_parallel_trains_like_jax_tp_fsdp_mesh(runs, mode):
    """Every rank logs the same global losses, equal to JAX's on its (2, 2)
    tp+fsdp mesh within LOSS_TOL; the clicks (data rank 0's rows, then data
    rank 1's) equal JAX's; the final parameters' L1 checksum within rtol
    1e-5; the mesh is JAX's layout, rank d*M + m at (d, m)."""
    ranks = runs["ranks"][mode]
    j_losses, j_clicks, j_checksum, compiles = runs["jax"]
    assert compiles == 1
    world = WORLDS[mode]
    assert all(r["mode"] == mode for r in ranks)
    assert ranks[0]["mesh"] == np.arange(world).reshape(-1, 2).tolist()
    for r in ranks:
        assert (r["data_rank"], r["model_rank"]) == divmod(r["rank"], 2)
        assert r["losses"] == ranks[0]["losses"]
        assert r["ious"] == ranks[0]["ious"]
        assert r["checksum"] == ranks[0]["checksum"]
    np.testing.assert_allclose(ranks[0]["losses"], j_losses, rtol=0,
                               atol=LOSS_TOL)
    for s in range(TW.STEPS):
        got = np.concatenate([np.asarray(r["clicks"][s]) for r in ranks
                              if r["model_rank"] == 0])
        np.testing.assert_array_equal(got, j_clicks[s], err_msg=f"step {s}")
        for r in ranks:         # a model group's ranks see the same rows
            peer = ranks[2 * r["data_rank"]]
            assert r["clicks"][s] == peer["clicks"][s]
    np.testing.assert_allclose(ranks[0]["checksum"], j_checksum, rtol=1e-5)
    assert ranks[0]["sharded"].startswith("FSDP") == (mode == "tp+fsdp")


def test_one_process_port_trains_like_jax_tp_fsdp_mesh(runs):
    """The one-process port (the ranks' checkpoint reference) against the
    same JAX trajectory."""
    s_losses, s_clicks, s_checksum = runs["single"]
    j_losses, j_clicks, j_checksum, _ = runs["jax"]
    np.testing.assert_allclose(s_losses, j_losses, rtol=0, atol=LOSS_TOL)
    for got, want in zip(s_clicks, j_clicks):
        np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_allclose(s_checksum, j_checksum, rtol=1e-5)


@pytest.mark.parametrize("mode", list(WORLDS))
def test_replicated_leaves_are_bit_identical_across_model_ranks(runs, mode):
    """Every leaf the ranks do not cut (norms, proj's and fc2's biases, the
    patch embedding, neck, DMA transformer, head) holds the same bits on
    the two model ranks of a data rank after the 3 steps: the block's
    operators give them the same gradient, which is not reduced again."""
    ranks = runs["ranks"][mode]
    for r in ranks:
        peer = ranks[2 * r["data_rank"]]
        assert set(r["digests"]) == set(peer["digests"])
        assert r["digests"] == peer["digests"], r["rank"]
    assert len(ranks[0]["digests"]) > 100


@pytest.mark.parametrize("mode", list(WORLDS))
def test_tensor_parallel_checkpoint_is_the_one_process_checkpoint(runs,
                                                                  mode):
    """Rank 0's checkpoint holds the whole leaves in JAX's layout (qkv's
    columns in (3, H, hd) order, the Adam moments too): the one-process
    port's within the module's tolerances, with the same keys, step and
    header; it loads in JAX's `load_checkpoint` and in one process exactly,
    and the one-process checkpoint loads back into tensor parallelism
    exactly."""
    work = runs["work"]
    want, wcfg, wstep, wextra = tser.load_checkpoint(
        work / "single" / "last_checkpoint.npz", opt_state=True)
    path = work / mode / "last_checkpoint.npz"
    got, gcfg, gstep, gextra = tser.load_checkpoint(path, opt_state=True)
    assert (gcfg, gstep) == (wcfg, wstep) and gstep == TW.STEPS
    assert set(got) == set(want)
    assert set(gextra["opt_state"]) == set(wextra["opt_state"])
    held = total = 0
    for k, v in want.items():
        err = np.abs(got[k] - v).reshape(-1)
        kb = _key_bias_rows(k, err.size)
        assert (err[kb] <= LR * TW.STEPS).all(), k
        err[kb] = 0
        small = runs["small"][k].reshape(-1)
        assert (err[small] <= LR * TW.STEPS).all(), k
        held += int((err[small] > PARAM_ATOL).sum())
        total += err.size
        err[small] = 0
        assert err.max() <= PARAM_ATOL, (k, float(err.max()))
    assert held * 10 ** 4 <= total, (held, total)
    for k, v in wextra["opt_state"].items():
        np.testing.assert_allclose(gextra["opt_state"][k].numpy(),
                                   v.numpy(), rtol=0, atol=MOMENT_ATOL,
                                   err_msg=k)
    # in JAX, leaf for leaf
    jparams, jcfg, jstep, _ = jser.load_checkpoint(path)
    jflat = jser.flatten_tree(jparams)
    assert jstep == TW.STEPS and set(jflat) == set(got)
    assert jser.config_to_dict(jcfg.model) == jser.config_to_dict(
        jax_tiny_params()[1])
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(jflat[k]), v)
    # in one process of the port, strictly
    model, mcfg = TW.tiny_model(work)
    tr = TW.Trainer(model, tts.TrainConfig(model=mcfg), TW.optimizer(model),
                    None, device="cpu")
    tr.resume(path)
    assert tr.global_step == TW.STEPS
    for n, p in tr.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), got[tser.jax_name(n)])
    for r in runs["ranks"][mode]:
        res = r["resume"]
        assert res["param_err"] == 0 and res["opt_err"] == 0
        assert res["opt_keys"] and res["step"] == TW.STEPS


def _jax_split_leaves(jcfg, model_parallel: int):
    """The weights (>= 2-D leaves) that JAX's `param_sharding(..., "tp")`
    splits over "model" on the VPU tree of `jcfg`, as the port's names."""
    tree = jax.eval_shape(lambda: jvpu.init_vpu(jax.random.key(0), jcfg))
    mesh = Mesh(np.asarray(jax.devices()[:model_parallel]).reshape(
        1, model_parallel), ("data", "model"))
    specs = jmesh.param_sharding(tree, mesh, "tp")
    out = set()
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        if any(name is not None for name in sh.spec):
            out.add(jmesh._path_str(path))
    return out


@pytest.mark.parametrize("mlp_ratio", [4.0, 65 / 64])
def test_the_port_splits_the_leaves_jax_splits(runs, mlp_ratio):
    """The 2-rank "tp" run cut exactly the weights that JAX's
    `param_sharding(..., "tp")` splits on the tiny VPU tree (M = 2), and
    qkv's and fc1's biases with them. At hidden width 65 (mlp_ratio
    65 / 64) JAX's divisibility fallback keeps fc1 and fc2 whole, and so
    does the port (the fake process group of a (1, 2) mesh, rank 1)."""
    import dataclasses
    _, jcfg = jax_tiny_params()
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(
        jcfg.backbone, mlp_ratio=mlp_ratio))
    want = _jax_split_leaves(jcfg, 2)
    if mlp_ratio == 4.0:
        cut = set(runs["ranks"]["tp"][0]["cut"])
    else:
        cut = _fake_split(tser.config_from_dict(jser.config_to_dict(jcfg)))
    assert {n for n in cut if n.endswith(".w")} == want
    biases = {n[:-2] + ".b" for n in want
              if n.endswith(("qkv.w", "fc1.w"))}
    assert {n for n in cut if n.endswith(".b")} == biases
    assert any(n.endswith("mlp.fc1.w") for n in want) == (mlp_ratio == 4.0)
    assert all("backbone" in n for n in want) and len(want) >= 8


def _fake_split(cfg):
    """The leaves `shard_params(..., "tp")` cuts on rank 1 of a (1, 2)
    mesh of torch's fake process group (no collective runs)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    tdist.init_process_group("fake", store=FakeStore(), rank=1,
                             world_size=2)
    try:
        model = registry.build(cfg, torch.Generator().manual_seed(0), "cpu")
        mesh = tmesh.make_mesh(model_parallel=2)
        tmesh.shard_params(model, mesh, "tp")
        return set(tmesh.tp_cuts(model))
    finally:
        tdist.destroy_process_group()


def _one_part_bwd(x2d, gamma, beta, w1, b1, w2, b2, eps, g):
    """`fused_ln_mlp_bwd` as it was written before its split into two
    parts, op for op: the reference the split must equal bit for bit."""
    bf = torch.bfloat16
    mm = fused_mlp.mm_f32
    w1b, w2b = w1.to(bf), w2.to(bf)
    xf = x2d.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc.mul_(rstd)
    gam = gamma.float()
    y = (xhat * gam + beta.float()).to(bf)
    h_pre = mm(y, w1b).add_(b1.float())
    h = torch.nn.functional.gelu(h_pre, approximate="tanh").to(bf)
    gb = g.to(bf)
    dw2 = mm(h.t(), gb).to(bf)
    db2 = gb.sum(0, dtype=torch.float32)
    dh = mm(gb, w2b.t())
    dh.copy_(dh.to(bf))
    dh_pre = torch.ops.aten.gelu_backward(dh, h_pre, approximate="tanh")
    db1 = dh_pre.sum(0)
    hi, lo = fused_mlp.split_bf16(dh_pre)
    dy = mm(hi, w1b.t()).add_(mm(lo, w1b.t())).to(bf)
    dw1 = mm(y.t(), hi).add_(mm(y.t(), lo)).to(bf)
    dyf = dy.float()
    dgamma = (dyf * xhat).sum(0)
    dbeta = dyf.sum(0)
    dxhat = dyf.mul_(gam)
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dx = dx.add_(gb.float()).to(x2d.dtype)
    return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def test_two_part_backward_without_a_reduction_is_todays_backward():
    """`fused_ln_mlp_bwd` is its local part and its LayerNorm part with no
    reduction between them: bit for bit the one-part function it was
    (`_one_part_bwd`) and the composed parts; and the TP-split parts' dy
    summed over two halves of the hidden width is the whole dy within f32
    rounding."""
    g = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    m, d, hid = 96, 64, 256
    x = torch.randn((m, d), generator=g).to(bf)
    gy = torch.randn((m, d), generator=g).to(bf)
    gamma, beta = (1 + 0.1 * torch.randn(d, generator=g),
                   0.1 * torch.randn(d, generator=g))
    w1, b1 = (0.05 * torch.randn((d, hid), generator=g),
              0.05 * torch.randn(hid, generator=g))
    w2, b2 = (0.05 * torch.randn((hid, d), generator=g),
              0.05 * torch.randn(d, generator=g))
    whole = fused_mlp.fused_ln_mlp_bwd(x, gamma, beta, w1, b1, w2, b2, 1e-6,
                                       gy)
    for a, b in zip(whole, _one_part_bwd(x, gamma, beta, w1, b1, w2, b2,
                                         1e-6, gy)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    xhat, rstd = fused_mlp._ln_stats(x, 1e-6)
    y = (xhat * gamma.float() + beta.float()).to(bf)
    dy32, dw1, db1, dw2 = fused_mlp.fused_ln_mlp_bwd_local(y, w1, b1, w2, gy)
    dx, dgamma, dbeta, db2 = fused_mlp.fused_ln_mlp_bwd_ln(
        xhat, rstd, gamma, dy32, gy)
    parts = (dx.to(bf), dgamma, dbeta, dw1.float(), db1, dw2.float(), db2)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    halves = [fused_mlp.fused_ln_mlp_bwd_local(
        y, ttp.local_part(w1, "cols", r, 2), ttp.local_part(b1, "cols", r, 2),
        ttp.local_part(w2, "rows", r, 2), gy) for r in range(2)]
    torch.testing.assert_close(halves[0][0] + halves[1][0], dy32,
                               rtol=1e-5, atol=1e-5)
    for r in range(2):          # the local weight gradients are the parts
        assert torch.equal(halves[r][1], ttp.local_part(dw1, "cols", r, 2))
        assert torch.equal(halves[r][3], ttp.local_part(dw2, "rows", r, 2))


def test_qkv_cut_is_by_heads_and_gathers_back():
    """qkv's part of model rank m is its heads' columns of q, k and v
    (s*D + h*hd + j), and the parts put back in order are the whole."""
    d, heads, size = 8, 4, 2
    w = torch.arange(3 * d, dtype=torch.float32).repeat(2, 1)
    got = [ttp.local_part(w, "qkv", r, size) for r in range(size)]
    hd = d // heads
    for r in range(size):
        cols = [s * d + h * hd + j for s in range(3)
                for h in range(r * heads // size, (r + 1) * heads // size)
                for j in range(hd)]
        assert got[r][0].tolist() == cols
    # q, k and v each: rank 0's heads, then rank 1's
    back = torch.cat([torch.cat([g[:, s * d // size:(s + 1) * d // size]
                                 for g in got], 1) for s in range(3)], 1)
    assert torch.equal(back, w)
    rows = ttp.local_part(torch.arange(12.0).reshape(6, 2), "rows", 1, 3)
    assert rows.tolist() == [[4.0, 5.0], [6.0, 7.0]]


def test_torchrun_trains_the_tiny_recipe_in_tp_mode(tmp_path):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    pvpuformer_tpu_torch.train <tiny recipe> --model-parallel 2
    --param-mode tp`: one experiment, its checkpoint whole (JAX's layout)
    and finite, and both ranks loading all 8 rows of each batch."""
    rc, out, err = torchrun(["-m", "pvpuformer_tpu_torch.train", str(TINY),
                             "--device", "cpu", "--model-parallel", "2",
                             "--param-mode", "tp", "--debug", "--workers",
                             "1"], tmp_path)
    assert rc == 0, (out[-2000:], err[-4000:])
    exps = list((tmp_path / "experiments" / "iSegNet"
                 / "vpu_tiny_synthetic").iterdir())
    assert len(exps) == 1
    flat, cfg, step, extra = tser.load_checkpoint(
        exps[0] / "checkpoints" / "000.npz", opt_state=True)
    assert step == 4 and extra["opt_state"]      # 32 samples / batch 8
    assert flat["backbone/blocks/#0/attn/qkv/w"].shape == (64, 192)
    assert flat["backbone/blocks/#0/mlp/fc2/w"].shape == (256, 64)
    assert all(np.isfinite(v).all() for v in flat.values())
    model = registry.load(flat, cfg.model)
    assert model.backbone.blocks[0].tp is None
