"""What every cell shares: finding cells, configurations, traffic mixes,
drivers and per-layer readers by name, the seeded model, the traced
window and its reduction, and the result line.

Everything is found by name under the root that holds BENCHMARK.json:
  configs/<config>.json       a model configuration (widths, dtype, source)
  traffic/<traffic>.json      a traffic mix: {"driver": <driver>, params}
  traffic/<driver>.py         one module per kind of traffic, `run(ctx)`
  metrics/<metric>.py         one reader per per-layer metric, `read(ctx)`,
                              found by the metric's name up to its first dot
The program under test is imported only inside functions, on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "pvpuformer_tpu")
GUARD_KERNELS = 40               # spin kernels that open a traced window
GUARD_CYCLES = 2_000_000         # about 1 ms each at the H100's clock


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# ------------------------------------------------------------ by name

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path, name: str):
    if not path.is_file():
        raise SystemExit(f"no {path.relative_to(path.parents[2])}: "
                         f"nothing is named {path.stem!r} there")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(there are {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    return Cell(name, cfg, mix, w["chips"],
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def load_driver(mix: dict, root: Path = ROOT):
    drv = mix["driver"]
    return _module(root / "benchmark" / "traffic" / f"{drv}.py",
                   f"benchmark.traffic.{drv}")


def load_reader(metric: str, root: Path = ROOT):
    base = metric.split(".", 1)[0]
    return _module(root / "benchmark" / "metrics" / f"{base}.py",
                   f"benchmark.metrics.{base}")


# ---------------------------------------------------------- the model

def vpu_config(cfg: dict, dtype=None):
    """The program's VPUConfig from a configuration file."""
    import torch
    from pvpuformer_tpu_torch.models.fpn import NeckConfig
    from pvpuformer_tpu_torch.models.seg_head import HeadConfig
    from pvpuformer_tpu_torch.models.two_way import TwoWayConfig
    from pvpuformer_tpu_torch.models.vit import ViTConfig
    from pvpuformer_tpu_torch.models.vpu import VPUConfig
    bb, nk, hd = cfg["backbone"], cfg["neck"], cfg["head"]
    crop = tuple(bb["img_size"])
    d = bb["embed_dim"]
    return VPUConfig(
        backbone=ViTConfig(img_size=crop, patch_size=tuple(bb["patch_size"]),
                           in_chans=3, embed_dim=d, depth=bb["depth"],
                           num_heads=bb["num_heads"],
                           mlp_ratio=bb["mlp_ratio"],
                           window_pixels=bb["window_pixels"]),
        neck=NeckConfig(in_dim=d, out_dims=tuple(nk["out_dims"]),
                        img_size=crop, hide_dim=nk["hide_dim"],
                        two_way=TwoWayConfig(embedding_dim=d, **nk["two_way"])),
        head=HeadConfig(in_channels=tuple(nk["out_dims"]),
                        channels=hd["channels"], upsample=hd["upsample"],
                        d_model=d),
        num_max_points=cfg["num_max_points"],
        norm_radius=cfg["norm_radius"],
        dtype=dtype or getattr(torch, cfg["dtype"]))


def build_model(cfg: dict, seed: int, device):
    """The program's VPU with weights drawn from `seed` on `device` in the
    configuration's dtype: (model, the draw's specs). The parameters are
    allocated there, zero, in that dtype, and filled by `weights.fill`."""
    import torch
    from pvpuformer_tpu_torch.models.vpu import VPUModel
    from benchmark import weights
    mcfg = vpu_config(cfg)
    old = torch.get_default_dtype()
    torch.set_default_dtype(mcfg.dtype)
    try:
        with torch.device(device):
            model = VPUModel(mcfg, None)
    finally:
        torch.set_default_dtype(old)
    model = model.to(device=device, dtype=mcfg.dtype)
    return model, weights.fill(model, seed)


# ------------------------------------------------------------- device

def prepare(clock: "Clock", device) -> None:
    """Set-up shared by every driver, each step on the clock: the CUDA
    context and the program's kernel library (built into build/kernels/
    of the checkout on its first run there, loaded after)."""
    import torch
    if device.type != "cuda":
        return
    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    clock.mark("CUDA context")
    from pvpuformer_tpu_torch.ops import _build
    _build.library()
    clock.mark("kernel library")


def card(chips: int):
    """The card, or exit when there is none or too few."""
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card")
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
            f"are present")
        raise SystemExit(2)
    return torch.device("cuda", 0)


def smi() -> str:
    """One nvidia-smi reading: name, power limit and draw, clocks, heat."""
    q = ("name,power.limit,power.draw,clocks.sm,clocks.mem,"
         "temperature.gpu,utilization.gpu")
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return r.stdout.strip() or r.stderr.strip()


def device_info(device, count: int, peak: int) -> dict:
    """The result's "device"; a CPU run (the tests') names the CPU."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": int(peak)}


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, seen in a traced window."""
    import torch
    with torch.profiler.record_function(name):
        yield


# -------------------------------------------------------- traced window

WINDOW = "bench.window"
NAME_CHARS = 160                 # a kernel's name, up to its arguments


@dataclasses.dataclass
class Trace:
    """A traced window reduced: device activity inside it (kernels,
    copies, sets), the host spans and ops, the window's bounds (us), and
    the traced work's seconds on the host clock."""
    start: float
    end: float
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    host_s: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def union(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.union()) * 1e-6

    def kernels(self, patterns: Sequence[str],
                exclude: Sequence[str] = ()) -> Tuple[float, int]:
        """(device seconds, launches) of device work whose name holds any
        of `patterns` and none of `exclude`."""
        t, n = 0.0, 0
        for name, a, b in self.device:
            if any(p in name for p in patterns) and not any(
                    x in name for x in exclude):
                t += (b - a) * 1e-6
                n += 1
        return t, n

    def top_ops(self, k: int = 10) -> List[List[Any]]:
        tot: Dict[str, float] = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[short_name(n), s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List[Any]]:
        """The longest gaps between device work, each named by what the
        host was in when it opened: the innermost benchmark span and the
        innermost host op."""
        u = self.union()
        edges = [self.start] + [x for ab in u for x in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            open_ = [(s, e, n) for n, s, e in self.host if s <= a < e]
            bench = [x for x in open_ if x[2].startswith("bench.")]
            ops = [x for x in open_ if not x[2].startswith("bench.")]
            label = "/".join(
                max(xs, key=lambda x: x[0])[2] for xs in (bench, ops) if xs)
            out.append([label or "host", (b - a) * 1e-6])
        return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most NAME_CHARS."""
    name = name.replace("(anonymous namespace)", "anon")
    return name.split("(", 1)[0].strip()[:NAME_CHARS]


def traced(fn: Callable[[], Any], host: bool = False) -> Tuple[Any, Trace]:
    """fn() under torch.profiler, opened by spin kernels (the profiler
    drops a session's first records); fn must end with its results on the
    host. By default only the device's activity is recorded, which leaves
    the host's pace as it is; every kernel, copy and set recorded after the
    spin kernels is fn's, and the trace spans them. With `host`, the
    host's ops and the benchmark's spans are recorded too, which stretches
    the host's part, and the window is a span of its own: a trace to name
    idle gaps by. Either way `host_s` is fn's time on the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        if cuda:
            for _ in range(GUARD_KERNELS):
                torch.cuda._sleep(GUARD_CYCLES)
            torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
        host_s = time.perf_counter() - t
    dev, host_ops, win = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the device-side copies of host spans are no device work
            if not (e.name.startswith("bench.") or "spin_kernel" in e.name
                    or getattr(e, "is_user_annotation", False)):
                dev.append((e.name, a, b))
        elif e.name == WINDOW and win is None:
            win = (a, b)
        else:
            host_ops.append((e.name, a, b))
    if cuda and not host:
        if not dev:
            raise RuntimeError("the trace holds no device activity")
        win = (min(d[1] for d in dev), max(d[2] for d in dev))
    if win is None:
        raise RuntimeError("the traced window's span is missing")
    dev = [d for d in dev if d[2] > win[0] and d[1] < win[1]]
    return out, Trace(win[0], win[1], dev, host_ops, host_s)


# -------------------------------------------------------- per layer

@dataclasses.dataclass
class LayerCtx:
    """What a per-layer reader may read: the configuration, the model
    batch of a round, the unprofiled window (rounds, seconds), the traced
    window and the rounds in it (one (canvas h, canvas w, sessions) each),
    and the host-clock seconds the traced work takes unprofiled."""
    cfg: dict
    model_batch: int
    rounds: int
    window_s: float
    trace: Trace
    traced_rounds: List[Tuple[int, int, int]]
    plain_s: float = 0.0


def per_layer(cell: Cell, ctx: LayerCtx, root: Path = ROOT) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        v = load_reader(m["name"], root).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


# -------------------------------------------------------------- result

def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def finish(result: dict, checks: Dict[str, Tuple[float, float, str]]) -> None:
    """Print the compared numbers beside their limits on stderr, then the
    result line (the compared numbers under "checks", last) on stdout."""
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded modules it must not: {bad}")
        raise SystemExit(3)
    for name, (value, limit, how) in checks.items():
        log(f"check {name}: {value!r} (limit {limit!r}, {how})")
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim, _) in checks.items()}
    print(json.dumps(result), flush=True)


class Clock:
    """Seconds since the process started running the harness."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.marks: List[Tuple[str, float]] = []

    def mark(self, what: str) -> None:
        self.marks.append((what, time.perf_counter() - self.t0))

    def split(self) -> str:
        prev, parts = 0.0, []
        for what, t in self.marks:
            parts.append(f"{what} {t - prev:.3f}")
            prev = t
        return ", ".join(parts)
