"""One rank of tests/test_torch_parallel.py's gloo process group on the CPU
(the port only: this process imports neither JAX nor the JAX package).

    python tests/torch_parallel_worker.py --work DIR [--model-parallel M]

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment, as
torch.distributed.run sets them. DIR holds what the parent test wrote:
  weights.npz   the tiny model (JAX `init_vpu`, JAX checkpoint format);
  noise.npz     JAX's draws of each training step at the global batch;
  single/last_checkpoint.npz   the one-process port's checkpoint.
In one process group (`parallel.dist.init`) the rank then
  * trains 3 steps of the global batch 8 (num_iters 2), this rank's rows
    from the port's `Loader`, once per parameter mode ("replicated",
    "fsdp"), through the Trainer's placement and `train_step`, and saves
    the Trainer's checkpoint under DIR/<mode>/;
  * loads the one-process checkpoint into a Trainer of each mode and reads
    it back whole;
  * evaluates SyntheticDataset(5 samples, 64 x 64) with
    `BatchedEvaluator(mesh=)`, B = 4 over the ranks, 3 clicks;
and writes DIR/rank<R>.json.

With --model-parallel M (tests/test_torch_tensor_parallel.py) the ranks form
the (W / M, M) mesh instead and, in the one mode that its shape names
("tp" at (1, M), "tp+fsdp" otherwise), train the same 3 steps of the same
global batches (data rank d's rows of tests/test_torch_parallel.py's
`global_batches`), save the gathered checkpoint under DIR/<mode>/, load the
one-process checkpoint back, and record the leaves they cut and a digest of
every leaf they do not; they write DIR/<mode>_rank<R>.json.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from mp_train_worker import make_dataset  # noqa: E402  (numpy only)
from pvpuformer_tpu_torch.data.loader import Loader  # noqa: E402
from pvpuformer_tpu_torch.engine import optimizer as topt  # noqa: E402
from pvpuformer_tpu_torch.engine import train_step as tts  # noqa: E402
from pvpuformer_tpu_torch.engine.trainer import Trainer  # noqa: E402
from pvpuformer_tpu_torch.models import registry  # noqa: E402
from pvpuformer_tpu_torch.parallel import dist  # noqa: E402
from pvpuformer_tpu_torch.parallel.mesh import (full_state_dict,  # noqa: E402
                                                make_mesh)
from pvpuformer_tpu_torch.utils.serialization import (  # noqa: E402
    load_checkpoint, params_from_numpy)

GLOBAL_BATCH = 8
STEPS = 3
NUM_ITERS = 2
THR = (0.4, 0.375, 0.425)
MODES = ("replicated", "fsdp")


def loader(rank: int, world: int) -> Loader:
    """tests/mp_train_worker.py:make_loader on the port's Loader."""
    return Loader(make_dataset(), batch_size=GLOBAL_BATCH, shuffle=True,
                  seed=5, num_workers=1, process_index=rank,
                  process_count=world)


def tiny_model(work: Path):
    flat, mcfg, _, _ = load_checkpoint(work / "weights.npz")
    return registry.load(flat, mcfg), mcfg


def optimizer(model):
    """mp_train_worker.run_train_steps' optimizer."""
    return topt.make_optimizer(model, "adam", lr=1e-3, milestones=(190, 210),
                               gamma=0.1, steps_per_epoch=10)


def step_noise(work: Path):
    """_train_noise's stand-in: JAX's draws of step `gen.initial_seed()`."""
    z = np.load(work / "noise.npz")

    def noise(cfg, gen, b, h, w, num_iters):
        s = gen.initial_seed()
        assert b == GLOBAL_BATCH, b
        return {"prompt_types": z[f"types{s}"].tolist(),
                "gumbel": torch.from_numpy(z[f"gumbel{s}"]),
                "box_offsets": torch.from_numpy(z[f"box_offsets{s}"]),
                "drop_u": torch.from_numpy(z[f"drop_u{s}"])}
    return noise


# the collectives that the port and FSDP2 call through torch.distributed
COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_gather_single",
               "reduce_scatter_single")


def count_collectives(counts):
    """Wrap torch.distributed's collectives to count their calls into
    `counts`; returns a function that unwraps them."""
    import torch.distributed as tdist
    saved = {n: getattr(tdist, n) for n in COLLECTIVES if hasattr(tdist, n)}

    def counted(name):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return saved[name](*a, **kw)
        return call

    for n in saved:
        setattr(tdist, n, counted(n))
    return lambda: [setattr(tdist, n, f) for n, f in saved.items()]


def train(model, mcfg, mesh, mode: str, batches, ckpt_dir=None, **kw):
    """STEPS steps through a Trainer's placement; returns (trainer, losses,
    this rank's clicks per step, global ious per step, collective calls of
    the steps)."""
    cfg = tts.TrainConfig(model=mcfg)
    trainer = Trainer(model, cfg, optimizer(model), None, device="cpu",
                      mesh=mesh, param_mode=mode, checkpoint_dir=ckpt_dir,
                      **kw)
    loop = tts._iterloss_loop
    seen = []

    def spy(*a, **k):
        out = loop(*a, **k)
        seen.append(out[1]["points"].numpy().tolist())
        return out

    tts._iterloss_loop = spy
    losses, ious, coll = [], [], {}
    restore = count_collectives(coll)
    try:
        for s, batch in enumerate(batches):
            logs, iou, _ = tts.train_step(
                trainer.model, trainer.tx, batch,
                torch.Generator().manual_seed(s), torch.tensor(THR),
                cfg=cfg, num_iters=NUM_ITERS, device="cpu", mesh=mesh)
            losses.append(float(logs["loss"]))
            ious.append(iou.numpy().tolist())
            trainer.global_step += 1
    finally:
        tts._iterloss_loop = loop
        restore()
    return trainer, losses, seen, ious, coll


def checksum(state) -> float:
    """mp_train_worker.run_train_steps' L1 checksum of the parameters."""
    return float(sum(float(t.float().abs().sum()) for t in state.values()))


def global_rows(d: int, n: int):
    """Data rank d of n's rows of the global batches of the 2-shard loader
    (rank 0's rows, then rank 1's): the same global batches at every n."""
    shards = [loader(p, 2) for p in range(2)]
    for _, parts in zip(range(STEPS), zip(*shards)):
        whole = {k: np.concatenate([b[k] for b in parts]) for k in parts[0]}
        rows = GLOBAL_BATCH // n
        yield {k: v[d * rows:(d + 1) * rows] for k, v in whole.items()}


def _resume_errors(trainer, want, extra):
    got = full_state_dict(trainer.model)
    opt = trainer.tx.state_dict()
    want_params = params_from_numpy(want)
    return {"param_err": max(float((got[k] - want_params[k]).abs().max())
                             for k in want_params),
            "opt_err": max(float((torch.as_tensor(opt[k])
                                  - torch.as_tensor(v)).abs().max())
                           for k, v in extra["opt_state"].items()),
            "opt_keys": sorted(opt) == sorted(extra["opt_state"]),
            "step": trainer.global_step}


def main_tensor_parallel(work: Path, m: int) -> None:
    """The --model-parallel run (see the module docstring)."""
    import hashlib
    from pvpuformer_tpu_torch.parallel.mesh import (data_rank, data_size,
                                                    model_rank, tp_cuts)
    from torch.distributed.tensor import DTensor
    mesh = make_mesh(model_parallel=m)
    mode = "tp" if data_size(mesh) == 1 else "tp+fsdp"
    tts._train_noise = step_noise(work)
    batches = list(global_rows(data_rank(mesh), data_size(mesh)))
    model, mcfg = tiny_model(work)
    trainer, losses, clicks, ious, coll = train(model, mcfg, mesh, mode,
                                                batches, work / mode)
    trainer.save(0)

    def local(p):
        return (p.to_local() if isinstance(p, DTensor) else p).detach()
    cut = tp_cuts(trainer.model)
    digests = {n: hashlib.sha256(local(p).numpy().tobytes()).hexdigest()
               for n, p in trainer.model.named_parameters() if n not in cut}
    out = {"rank": dist.get_rank(), "data_rank": data_rank(mesh),
           "model_rank": model_rank(mesh), "mode": mode,
           "mesh": mesh.mesh.tolist(), "losses": losses, "clicks": clicks,
           "ious": ious, "collectives": coll, "cut": sorted(cut),
           "digests": digests,
           "checksum": checksum(full_state_dict(trainer.model)),
           "sharded": type(trainer.model).__name__}
    want, _, _, extra = load_checkpoint(work / "single" /
                                        "last_checkpoint.npz",
                                        opt_state=True)
    model, mcfg = tiny_model(work)
    t2 = Trainer(model, tts.TrainConfig(model=mcfg), optimizer(model),
                 None, device="cpu", mesh=mesh, param_mode=mode)
    t2.resume(work / "single" / "last_checkpoint.npz")
    out["resume"] = _resume_errors(t2, want, extra)
    (work / f"{mode}_rank{dist.get_rank()}.json").write_text(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", required=True)
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args()
    work = Path(args.work)
    torch.set_num_threads(2)
    dist.init("cpu")
    if args.model_parallel > 1:
        try:
            main_tensor_parallel(work, args.model_parallel)
        finally:
            dist.shutdown()
        return
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh()
    tts._train_noise = step_noise(work)
    batches = [b for _, b in zip(range(STEPS), loader(rank, world))]
    out = {"rank": rank, "world": world, "train": {}, "resume": {}}
    single = work / "single" / "last_checkpoint.npz"
    want, _, _, extra = load_checkpoint(single, opt_state=True)
    for mode in MODES:
        model, mcfg = tiny_model(work)
        trainer, losses, clicks, ious, coll = train(model, mcfg, mesh, mode,
                                                    batches, work / mode)
        trainer.save(0)
        out["train"][mode] = {
            "losses": losses, "clicks": clicks, "ious": ious,
            "collectives": coll,
            "checksum": checksum(full_state_dict(trainer.model)),
            "sharded": type(trainer.model).__name__}
        # the one-process checkpoint, placed on this mode's mesh
        model, mcfg = tiny_model(work)
        t2 = Trainer(model, tts.TrainConfig(model=mcfg), optimizer(model),
                     None, device="cpu", mesh=mesh, param_mode=mode)
        t2.resume(single)
        out["resume"][mode] = _resume_errors(t2, want, extra)

    from pvpuformer_tpu_torch.inference.batched import BatchedEvaluator
    from pvpuformer_tpu_torch.inference.datasets import SyntheticDataset
    from pvpuformer_tpu_torch.inference.predictor import PredictorConfig
    model, mcfg = tiny_model(work)
    pcfg = PredictorConfig(model=mcfg, target_size=(64, 64), min_crop_size=32)
    bev = BatchedEvaluator(model, pcfg, batch_size=4, device="cpu",
                           mesh=mesh)
    curves, _, _ = bev.evaluate(SyntheticDataset(n_samples=5, hw=(64, 64)),
                                max_clicks=3, max_iou_thr=0.95)
    out["eval"] = {"curves": [c.tolist() for c in curves],
                   "clicks": [c.tolist() for c in bev.clicks]}
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    dist.shutdown()


if __name__ == "__main__":
    main()
