"""The port's scale-out (parallel/, the Trainer's mesh, BatchedEvaluator's
mesh, the CLIs' mesh flags) against the JAX package and against its own one
process, on the CPU at the tiny config (embed 64, depth 4, 64 x 64), f32.

Two gloo ranks (tests/torch_parallel_worker.py, port only) train 3 steps of
the global batch 8 of tests/mp_train_worker.py's records (num_iters 2,
JAX's draws of keys 0-2 injected) in "replicated" and in "fsdp" mode; the
reference is JAX's train step (`iterloss_value_and_grad`, the optax
update; JAX `train_step`'s body, jitted once, with the clicks returned) on
a 2-device data mesh of conftest's CPU devices, over the same global
batches. Tolerances: losses 1e-5 (tests/test_torch_train.py's port-vs-JAX
loss bound), clicks exact, the L1 parameter checksum rtol 1e-5 (JAX's
tests/test_multiprocess.py:80-81). The 2-rank checkpoint against the
one-process port's: the Adam moments (the gradients' running sums) within
MOMENT_ATOL, 3x the 3.0e-8 measured (f32 noise of the all-reduce's other
summation order); the parameters within PARAM_ATOL, 4x the 4.7e-6
measured: Adam divides each gradient by its own running scale, so an
element with a small gradient moves by its rounding noise times lr. The
key projections' biases are held only to lr x steps, the farthest Adam
moves a leaf: their exact gradient is 0 (a softmax ignores a constant added
to every score of a query), so each of their Adam steps is rounding noise
normalized to up to lr (measured 3.6e-4 apart).

Every process this file starts is waited on for at most CHILD_TIMEOUT
seconds and then killed, and every process group has a 120-s timeout
(parallel/dist.TIMEOUT_S): ranks that wait on each other fail instead of
hanging the suite.
"""
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pvpuformer_tpu.engine import optimizer as jopt, train_step as jts
from pvpuformer_tpu.utils import serialization as jser
from pvpuformer_tpu_torch.engine import train_step as tts
from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
from pvpuformer_tpu_torch.inference.predictor import PredictorConfig
from pvpuformer_tpu_torch.parallel import dist, mesh as tmesh
from pvpuformer_tpu_torch.utils import serialization as tser

import torch_parallel_worker as TW
from test_torch_grad import jax_tiny_params
from test_torch_train import jax_train_noise

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_parallel_worker.py"
TINY = REPO / "pvpuformer_tpu_torch" / "recipes" / "iSegNet" / \
    "vpu_tiny_synthetic.py"
CHILD_TIMEOUT = 180
LOSS_TOL = 1e-5
MOMENT_ATOL = 1e-7
PARAM_ATOL = 2e-5
LR = 1e-3                               # TW.optimizer's


def _key_bias_rows(name: str, n: int):
    """The rows of a leaf that are a key projection's bias."""
    if name.endswith("/k/b"):
        return slice(0, n)
    if name.endswith("qkv/b"):
        return slice(n // 3, 2 * n // 3)
    return slice(0, 0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra)
    return env


def run_children(cmds, cwd, envs, wait=True):
    """Start the commands together, wait for each at most CHILD_TIMEOUT
    seconds (then kill them all); returns their (rc, stdout, stderr), or
    with wait=False a function that waits so and returns them."""
    procs = [subprocess.Popen(c, cwd=cwd, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, e in zip(cmds, envs)]

    def finish():
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=CHILD_TIMEOUT)
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return outs
    if not wait:
        return finish
    return finish()


def torchrun(args, cwd, nproc=2):
    """`python -m torch.distributed.run --nproc-per-node nproc ...` on a
    free port of 127.0.0.1."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc-per-node={nproc}", "--master-addr=127.0.0.1",
           f"--master-port={free_port()}"] + args
    return run_children([cmd], cwd, [_env()])[0]


# ---------------------------------------------------------------------------
# the references and the 2-rank run, once per module
# ---------------------------------------------------------------------------

def global_batches():
    """The global batches of the 2-rank run: rank 0's rows, then rank 1's
    (mp_train_worker.global_batch_order on the port's Loader)."""
    shards = [TW.loader(p, 2) for p in range(2)]
    for _, parts in zip(range(TW.STEPS), zip(*shards)):
        yield {k: np.concatenate([b[k] for b in parts]) for k in parts[0]}


@functools.partial(jax.jit, static_argnames=("cfg", "tx", "num_iters"))
def _jax_step(params, opt_state, batch, key, *, cfg, tx, num_iters):
    """JAX `train_step`'s update (train_step.py:341-355), returning the
    loss and the clicks."""
    (loss, aux), grads = jts.iterloss_value_and_grad(params, cfg, batch, key,
                                                     num_iters)
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, \
        aux["points"]


def jax_reference(batches):
    """(losses, clicks per step, checksum) of JAX's step on a 2-device data
    mesh: parameters replicated, the batch over "data"."""
    params, jcfg = jax_tiny_params()
    cfg = jts.TrainConfig(model=jcfg)
    tx = jopt.make_optimizer(params, "adam", lr=1e-3, milestones=(190, 210),
                             gamma=0.1, steps_per_epoch=10)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    repl, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    # the optimizer state placed as the step returns it: one compile
    params, opt_state = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl), (params, tx.init(params)))
    losses, clicks = [], []
    with mesh:
        for s, batch in enumerate(batches):
            gb = {k: jax.device_put(jnp.asarray(v), rows)
                  for k, v in batch.items()}
            params, opt_state, loss, pts = _jax_step(
                params, opt_state, gb, jax.random.key(s), cfg=cfg, tx=tx,
                num_iters=TW.NUM_ITERS)
            losses.append(float(loss))
            clicks.append(np.asarray(pts))
    checksum = float(sum(jnp.sum(jnp.abs(leaf.astype(jnp.float32)))
                         for leaf in jax.tree_util.tree_leaves(params)))
    return losses, clicks, checksum


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)                # as each rank
    try:
        yield _runs(tmp_path_factory.mktemp("parallel"))
    finally:
        torch.set_num_threads(threads)


def write_inputs(work):
    """What the workers read: the tiny JAX model (weights.npz) and JAX's
    draws of each step (noise.npz); returns the global batches."""
    params, jcfg = jax_tiny_params()
    jser.save_checkpoint(work / "weights.npz", params, jcfg)
    noise = {}
    for s in range(TW.STEPS):
        z = jax_train_noise(jax.random.key(s), TW.GLOBAL_BATCH, 64, 64,
                            TW.NUM_ITERS)
        noise[f"types{s}"] = np.asarray(z["prompt_types"], np.int32)
        for k in ("gumbel", "box_offsets", "drop_u"):
            noise[f"{k}{s}"] = z[k].numpy()
    np.savez(work / "noise.npz", **noise)
    return list(global_batches())


def _runs(work):
    batches = write_inputs(work)

    # the one-process port on the concatenated batches
    orig = tts._train_noise
    tts._train_noise = TW.step_noise(work)
    try:
        model, mcfg = TW.tiny_model(work)
        single, s_losses, s_clicks, s_ious, _ = TW.train(
            model, mcfg, None, "replicated", batches, work / "single")
        single.save(0)
    finally:
        tts._train_noise = orig

    port = free_port()
    cmds = [[sys.executable, str(WORKER), "--work", str(work)]] * 2
    envs = [_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            for r in range(2)]
    finish = run_children(cmds, REPO, envs, wait=False)
    jax_ref = jax_reference(batches)        # compiles while the ranks run
    for rc, out, err in finish():
        assert rc == 0, (out[-2000:], err[-4000:])
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    return {"work": work, "batches": batches, "ranks": ranks,
            "jax": jax_ref,
            "single": (s_losses, s_clicks, s_ious,
                       TW.checksum(single.model.state_dict()))}


@pytest.mark.parametrize("mode", TW.MODES)
def test_two_ranks_train_like_jax_on_a_data_mesh(runs, mode):
    """Both ranks log the same global losses, equal to JAX's on a 2-device
    data mesh within LOSS_TOL; the clicks (rank 0's rows, then rank 1's)
    equal JAX's; the final parameters' L1 checksum within rtol 1e-5."""
    r0, r1 = (r["train"][mode] for r in runs["ranks"])
    assert r0["losses"] == r1["losses"]
    assert r0["ious"] == r1["ious"]
    j_losses, j_clicks, j_checksum = runs["jax"]
    np.testing.assert_allclose(r0["losses"], j_losses, rtol=0, atol=LOSS_TOL)
    for s in range(TW.STEPS):
        got = np.concatenate([np.asarray(r0["clicks"][s]),
                              np.asarray(r1["clicks"][s])])
        np.testing.assert_array_equal(got, j_clicks[s], err_msg=f"step {s}")
    np.testing.assert_allclose(r0["checksum"], j_checksum, rtol=1e-5)
    assert r0["checksum"] == r1["checksum"]
    assert r0["sharded"].startswith("FSDP") == (mode == "fsdp")
    # one gradient all-reduce per step (all the gradients when replicated,
    # the 0-d leaves beside FSDP's shards) and one of the logs and metrics
    assert r0["collectives"]["all_reduce"] == 2 * TW.STEPS, r0["collectives"]
    assert r0["collectives"] == r1["collectives"]
    if mode == "replicated":
        assert set(r0["collectives"]) == {"all_reduce"}
    else:   # one reduce-scatter per FSDP group (4 blocks, the root) a step
        assert sum(v for k, v in r0["collectives"].items()
                   if k.startswith("reduce_scatter")) == 5 * TW.STEPS


def test_one_process_port_trains_like_jax(runs):
    """The one-process port on the concatenated batches (the 2-rank runs'
    reference) against the same JAX trajectory."""
    s_losses, s_clicks, s_ious, s_checksum = runs["single"]
    j_losses, j_clicks, j_checksum = runs["jax"]
    np.testing.assert_allclose(s_losses, j_losses, rtol=0, atol=LOSS_TOL)
    for got, want in zip(s_clicks, j_clicks):
        np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_allclose(s_checksum, j_checksum, rtol=1e-5)
    for mode in TW.MODES:
        np.testing.assert_allclose(runs["ranks"][0]["train"][mode]["ious"],
                                   s_ious, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", TW.MODES)
def test_two_rank_checkpoint_is_the_one_process_checkpoint(runs, mode):
    """Rank 0's checkpoint holds the whole parameters and Adam moments: the
    one-process port's within the module's tolerances, with the same keys,
    step and header; it loads in one process, and the one-process
    checkpoint loads on both ranks exactly."""
    work = runs["work"]
    want, wcfg, wstep, wextra = tser.load_checkpoint(
        work / "single" / "last_checkpoint.npz", opt_state=True)
    got, gcfg, gstep, gextra = tser.load_checkpoint(
        work / mode / "last_checkpoint.npz", opt_state=True)
    assert (gcfg, gstep) == (wcfg, wstep) and gstep == TW.STEPS
    assert set(got) == set(want)
    assert set(gextra["opt_state"]) == set(wextra["opt_state"])
    for k, v in want.items():
        err = np.abs(got[k] - v).reshape(-1)
        kb = _key_bias_rows(k, err.size)
        assert (err[kb] <= LR * TW.STEPS).all(), k
        err[kb] = 0
        assert err.max() <= PARAM_ATOL, (k, float(err.max()))
    for k, v in wextra["opt_state"].items():
        np.testing.assert_allclose(gextra["opt_state"][k].numpy(),
                                   v.numpy(), rtol=0, atol=MOMENT_ATOL,
                                   err_msg=k)
    # the 2-rank file in one process
    model, mcfg = TW.tiny_model(work)
    tr = TW.Trainer(model, tts.TrainConfig(model=mcfg), TW.optimizer(model),
                    None, device="cpu")
    tr.resume(work / mode / "last_checkpoint.npz")
    assert tr.global_step == TW.STEPS
    for n, p in tr.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), got[tser.jax_name(n)])
    # the one-process file on both ranks of this mode
    for r in runs["ranks"]:
        res = r["resume"][mode]
        assert res["param_err"] == 0 and res["opt_err"] == 0
        assert res["opt_keys"] and res["step"] == TW.STEPS


def test_loader_shards_partition_the_global_batch():
    """Two `Loader` shards partition each global batch: disjoint, and their
    union is the one-loader batch (DistributedSampler's semantics)."""
    full = next(iter(TW.loader(0, 1)))
    halves = [next(iter(TW.loader(p, 2))) for p in range(2)]
    assert all(h["image"].shape[0] == TW.GLOBAL_BATCH // 2 for h in halves)

    def rows(b):
        return sorted(map(tuple, b["image"].reshape(len(b["image"]), -1)[:, :8]))
    union = {k: np.concatenate([h[k] for h in halves]) for k in full}
    assert rows(union) == rows(full)
    assert len(set(rows(halves[0])) | set(rows(halves[1]))) == \
        TW.GLOBAL_BATCH


def test_sharded_batched_evaluator_matches_one_process(runs):
    """BatchedEvaluator(mesh=) over 2 ranks, B = 4 (2 sessions a rank):
    the curves of the one-process B = 4 evaluator (IoU 2e-5, JAX's
    tests/test_batched.py bound), the same clicks, on both ranks."""
    model, mcfg = TW.tiny_model(runs["work"])
    pcfg = PredictorConfig(model=mcfg, target_size=(64, 64), min_crop_size=32)
    bev = BatchedEvaluator(model, pcfg, batch_size=4, device="cpu")
    curves, _, _ = bev.evaluate(SyntheticDataset(n_samples=5, hw=(64, 64)),
                                max_clicks=3, max_iou_thr=0.95)
    assert len(curves) == 5
    for r in runs["ranks"]:
        got = r["eval"]
        assert len(got["curves"]) == len(curves)
        for a, b in zip(got["curves"], curves):
            assert len(a) == len(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
        for a, b in zip(got["clicks"], bev.clicks):
            np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# the CLIs under torch.distributed.run
# ---------------------------------------------------------------------------

def test_torchrun_trains_the_tiny_recipe_in_fsdp_mode(tmp_path):
    rc, out, err = torchrun(["-m", "pvpuformer_tpu_torch.train", str(TINY),
                             "--device", "cpu", "--param-mode", "fsdp",
                             "--debug", "--workers", "1"], tmp_path)
    assert rc == 0, (out[-2000:], err[-4000:])
    exps = list((tmp_path / "experiments" / "iSegNet"
                 / "vpu_tiny_synthetic").iterdir())
    assert len(exps) == 1                   # rank 1 joined rank 0's
    ckpts = sorted(p.name for p in (exps[0] / "checkpoints").iterdir())
    assert ckpts == ["000.npz", "last_checkpoint.npz"]
    flat, cfg, step, extra = tser.load_checkpoint(
        exps[0] / "checkpoints" / "000.npz", opt_state=True)
    assert step == 4 and extra["opt_state"]      # 32 samples / batch 8
    assert all(np.isfinite(v).all() for v in flat.values())


def _noc_row(out: str):
    """The NoBRS results row without its SPC and Time cells (wall clock)."""
    row = next(line for line in out.splitlines()
               if line.startswith("|") and "NoBRS" in line)
    return row.split("|")[1:-3]


def test_torchrun_eval_mesh_prints_the_one_process_table(runs, tmp_path,
                                                         capsys):
    from pvpuformer_tpu_torch import evaluate as cli
    common = ["--checkpoint", str(runs["work"] / "weights.npz"),
              "--datasets", "Synthetic", "--limit", "3", "--n-clicks", "3",
              "--dtype", "float32", "--batched", "4", "--device", "cpu"]
    cli.main(common + ["--logs-path", str(tmp_path / "one")])
    want = capsys.readouterr().out
    rc, out, err = torchrun(["-m", "pvpuformer_tpu_torch.evaluate"] + common
                            + ["--eval-mesh", "2", "--logs-path",
                               str(tmp_path / "two")], tmp_path)
    assert rc == 0, (out[-2000:], err[-4000:])
    assert out.count("NoBRS") == want.count("NoBRS") == 1   # rank 0 prints
    assert _noc_row(out) == _noc_row(want)


@pytest.mark.parametrize("argv,message", [
    (["--eval-mesh", "2"], "needs --batched"),
    (["--batched", "3", "--eval-mesh", "2"], "divisible"),
    (["--batched", "4", "--eval-mesh", "2"], "torch.distributed.run")])
def test_eval_mesh_needs_a_process_group_of_its_size(argv, message, capsys,
                                                      monkeypatch):
    from pvpuformer_tpu_torch import evaluate as cli
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["--random-weights", "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("call", ["mesh_model_parallel", "shard_tp",
                                  "shard_tp_fsdp", "train_flag"])
def test_tensor_parallel_modes_build_their_mesh_and_placement(call):
    """The tensor-parallel mesh and modes are accepted (they refused before
    they were ported): `make_mesh(4, model_parallel=2)` is JAX's (2, 2)
    layout, rank d*2 + m at (d, m); "tp" and "tp+fsdp" cut each backbone
    block's qkv / fc1 / proj / fc2 (rank 1's part) and, under FSDP, shard
    it over "data"; train.py parses both flags. Built on rank 1 of a
    4-rank fake process group (no collective runs)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from pvpuformer_tpu_torch import train as ttrain
    from pvpuformer_tpu_torch.models.vit import ViT, ViTConfig
    if call == "train_flag":
        args = ttrain.parse_args([str(TINY), "--model-parallel", "2",
                                  "--param-mode", "tp+fsdp"])
        assert (args.model_parallel, args.param_mode) == (2, "tp+fsdp")
        return
    tdist.init_process_group("fake", store=FakeStore(), rank=1,
                             world_size=4)
    try:
        m = tmesh.make_mesh(4, model_parallel=2)
        assert m.mesh.tolist() == [[0, 1], [2, 3]]
        assert m.mesh_dim_names == ("data", "model")
        assert (tmesh.data_rank(m), tmesh.model_rank(m),
                tmesh.data_size(m), tmesh.model_size(m)) == (0, 1, 2, 2)
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.make_mesh(4, model_parallel=3)
        if call == "mesh_model_parallel":
            return
        cfg = ViTConfig(img_size=(32, 32), embed_dim=64, depth=4,
                        num_heads=2)
        model = torch.nn.Module()
        model.backbone = ViT(cfg, torch.Generator().manual_seed(0))
        whole = {n: p.detach().clone()
                 for n, p in model.named_parameters()}
        mode = "tp" if call == "shard_tp" else "tp+fsdp"
        assert tmesh.shard_params(model, m, mode) is model
        assert tmesh.is_split(model)
        assert tmesh.is_sharded(model) == (mode == "tp+fsdp")
        cuts = tmesh.tp_cuts(model)
        assert len(cuts) == 6 * cfg.depth
        for n, p in model.named_parameters():
            local = p.to_local() if hasattr(p, "to_local") else p
            if n not in cuts:
                assert tuple(p.shape) == tuple(whole[n].shape), n
                continue
            want = tmesh.local_part(whole[n], cuts[n].kind, 1, 2)
            assert tuple(p.shape) == tuple(want.shape), n
            if mode == "tp":
                assert torch.equal(local, want), n
        blk = model.backbone.blocks[0]
        assert (blk.tp.rank, blk.tp.size, blk.tp.attn, blk.tp.mlp) == \
            (1, 2, True, True)
    finally:
        tdist.destroy_process_group()


def test_without_a_process_group_everything_is_one_device():
    """JAX's one-process answers, and no mesh: every mode leaves the model
    and the batch as they are."""
    assert not dist.initialized()
    assert (dist.get_rank(), dist.get_world_size(), dist.is_master()) == \
        (0, 1, True)
    dist.synchronize()
    m = {"a": 1.5, "b": torch.tensor(2.0)}
    assert dist.reduce_metrics(m) == m
    assert tmesh.make_mesh() is None and tmesh.make_mesh(1) is None
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tmesh.make_mesh(2)
    model = torch.nn.Linear(2, 2)
    before = list(model.parameters())
    for mode in tmesh.MODES:
        assert tmesh.shard_params(model, None, mode) is model
    assert list(model.parameters()) == before
    batch = {"x": np.arange(8).reshape(4, 2)}
    assert tmesh.shard_batch(batch, None) is batch
    t = torch.arange(6.0)
    assert dist.gather_rows(t) is t
