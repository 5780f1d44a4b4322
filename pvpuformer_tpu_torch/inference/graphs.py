"""Click rounds replayed from CUDA graphs: the port's counterpart of JAX's
compiled session (pvpuformer_tpu/inference/predictor.py: `click_step`,
`user_click_step` and `click_scan` under `jax.jit`, one program per shape).

`click_rounds` and `user_click_round` are the one entry of the session
classes (`Predictor`, `BatchedEvaluator`). Off the card they run the eager rounds
of `predictor`, which stay the definition. On the card a round,
`predictor._click_step` over a batch of sessions or one
`predictor._user_click_step`, is captured into a `torch.cuda.CUDAGraph` per
key (the model, where each of its parameters and buffers lies, the
PredictorConfig, canvas shape, batch size, kind) and replayed. A key's
first round runs eagerly on the capture stream, which also sets up what a
capture needs there (cuBLAS's workspace for the stream); its second round,
in the same run or a later one, is captured and replayed; later rounds
replay. So a one-click session on a new canvas pays no capture, and a
longer one pays it once.

What a replay needs besides the graph:
  * static inputs: the state is copied in before a run of rounds, each
    captured round ends by copying its new state into them (so the next
    replay continues the session), and the state is copied out once, as
    fresh tensors that an undo stack may keep: no replay writes them;
  * the round's other inputs, the prompt draws or a person's click: made
    outside the graph (the draws on the host, from the caller's generator
    in the eager loop's order) and copied into static buffers before each
    replay; a draw inside the capture would bake in a freed pinned buffer.

The kernel wrappers count their calls where they launch: in the eager
round and in the capture (which records the launches into the graph). A
replay makes no call, so it counts nothing; what a replay runs on the card
shows in a profiler trace. `rounds` counts the rounds run eagerly,
captured and replayed.

Tracing (`utils/profiling.py`): the steps of a run are host spans
(`graphs.prepare`: key, lookup, first meeting, copy-in; `graphs.eager`,
`graphs.capture`, `graphs.replay`: the launch; `graphs.finish`: IoU
clone, copy-out, stack), and every round reports its kind
(`profiling.note_rounds`). A captured round carries its model stages'
marks (`profiling.stages`: seven event-record nodes a round, the last
after the copy into the static state). Before a graph's next replay
rewrites them, the marks of its last replay are read if the card has
passed them, and dropped if not: nothing waits for them. In the session
drivers the IoU's host read has waited for every round, so each is read;
in a batched chunk the launches run ahead of the card, so the chunk's
last round is. While a torch profiler records, an eager round on the
card records and reads the same marks.

Graphs live in a small LRU cache (MAX_GRAPHS) and share one memory pool
per device. No two runs overlap: one lock covers copy-in, replays and
copy-out, and each run's stream waits for the previous run's end (an
event), so runs on different streams are ordered too. That keeps the
shared pool safe (a graph's outputs are consumed before another replays)
and the CC kernels' grid barrier: a graph keeps the barrier word of the
capture stream (`ops/cc.py`), which all graphs share. The LN+MLP kernel's
tensor maps, baked into a graph as kernel parameters, are cached by
(address, shape, box) (`csrc/fused_mlp.cu`); a map's content is a
function of that key alone, so a cached map stays right for any later
tensor at an address that an evicted graph used.

Nothing falls back: a capture or replay that fails raises.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..utils import profiling
from . import predictor as _pred

# Eight graphs: on the H100 a batch-1 ViT-B@448 graph adds ~0.02 GiB to
# the shared pool and a batch-8 one ~0.3 GiB, and short sessions over six
# canvas buckets met in turn ran faster with 8 than with 4
# (chip_smoke.phase_graph_cache, PERF.md section 5).
MAX_GRAPHS = 8
MAX_SEEN = 64             # keys met once, remembered for their capture

Extra = Dict[str, torch.Tensor]


class _Device:
    """What the rounds of one card share: one capture stream, reused (torch
    keeps a 32 MiB cuBLAS workspace for every stream a product ran on), the
    graphs' memory pool and the end of the last run. The CUDA calls of this
    module are its methods (tests put a CPU stand-in in its place)."""

    def __init__(self, device: torch.device):
        self.device = device
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream()
            self.done = torch.cuda.Event()
        self.pool = torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def run(self):
        """The card current, and this run's stream ordered after the end of
        the previous run on any stream."""
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            cur.wait_event(self.done)
            yield
            self.done.record(cur)

    def eager(self, fn):
        """fn() on the capture stream, ordered after and before the current
        stream."""
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    @staticmethod
    def event() -> torch.cuda.Event:
        """A stage mark: a timing event that a capture records as an
        event-record node of the graph."""
        return torch.cuda.Event(enable_timing=True, external=True)

    def capture(self, fn, fresh: bool):
        """fn() captured into a CUDA graph on the capture stream, in the
        shared pool (a new one if `fresh`): (the graph, fn's outputs). Not
        `torch.cuda.graph`, which first empties the allocator's device
        cache and the pinned host cache: every later allocation of the
        process would then be a fresh cudaMalloc / cudaHostAlloc (the
        prompt draws' copies use pinned memory). That emptying is also
        what frees a pool no graph holds any more, and the allocator
        refuses to capture into such a pool: once every graph of the card
        is dropped, the next capture takes a new pool (the old one's
        memory goes with `torch.cuda.empty_cache()`)."""
        if fresh:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        return graph, out


class _Round:
    """One captured round: the graph, its static inputs (`state`, `extra`),
    which state fields the round writes, what it returns (held so that
    its memory stays the graph's), its stage marks and the kind of its
    last replay while that replay's marks are unread."""

    def __init__(self, model, graph, state, changed, extra, out, iou, marks):
        self.model = weakref.ref(model)
        self.graph = graph
        self.state, self.changed, self.extra = state, changed, extra
        self.out, self.iou = out, iou
        self.marks = marks
        self.unread: Optional[str] = None

    def read_marks(self) -> None:
        """Read the last replay's stage marks if the card has passed them,
        with no wait; the next replay records them again, so marks left
        unread are dropped."""
        if self.unread is not None:
            profiling.read_stages(self.marks, self.unread, wait=False)
            self.unread = None


_lock = threading.Lock()
_graphs: "OrderedDict[tuple, _Round]" = OrderedDict()
_seen: "OrderedDict[tuple, None]" = OrderedDict()
_devices: Dict[torch.device, _Device] = {}
rounds = {"eager": 0, "captured": 0, "replayed": 0}


def replayed(device: torch.device) -> bool:
    """Whether rounds on `device` are replayed: on the card. The CPU runs
    the eager rounds."""
    return device.type == "cuda"


def clear() -> None:
    """Drop every captured round (their pool's memory is released by
    `torch.cuda.empty_cache()` once no graph uses it) and every key met."""
    with _lock:
        _graphs.clear()
        _seen.clear()


def _weights_at(model) -> tuple:
    """Where the model's tensors lie: a graph reads the storage of every
    parameter and buffer it was captured with, and an in-place cast or
    move gives them new storage."""
    return tuple(t.data_ptr() for t in
                 (*model.parameters(), *model.buffers()))


def _key(model, cfg, kind: str, states) -> tuple:
    return (id(model), _weights_at(model), cfg, kind,
            tuple(states.gt.shape), states.gt.device)


@contextlib.contextmanager
def _run(device: torch.device):
    """The lock, no grad, and `device`'s run (`_Device.run`)."""
    with _lock, torch.no_grad():
        dev = _devices.get(device)
        if dev is None:
            dev = _devices[device] = _Device(device)
        with dev.run():
            yield dev


def _lookup(key: tuple, model) -> Optional[_Round]:
    r = _graphs.get(key)
    if r is None or r.model() is not model:
        return None
    _graphs.move_to_end(key)
    return r


def _first_meeting(key: tuple) -> bool:
    """Whether `key` is met for the first time (then it is remembered)."""
    if key in _seen:
        _seen.move_to_end(key)
        return False
    _seen[key] = None
    while len(_seen) > MAX_SEEN:
        _seen.popitem(last=False)
    return True


def _insert(key: tuple, r: _Round) -> None:
    _graphs[key] = r
    for k in [k for k, v in _graphs.items() if v.model() is None]:
        del _graphs[k]
    while len(_graphs) > MAX_GRAPHS:
        _graphs.popitem(last=False)


def _capture(model, key: tuple, dev: _Device, states, extra: Extra,
             body: Callable) -> _Round:
    """Capture body(state, extra) -> (state, ious) on static buffers (copies
    of `states` / `extra`, so the round is ready to replay), ending with the
    new state copied into the static state."""
    state = _pred.SessionState(*(t.clone() for t in states))
    extra = {k: v.clone() for k, v in extra.items()}
    marks = []

    def round_():
        with profiling.stages(dev.event) as m:
            out, iou = body(state, extra)
            for o, s in zip(out, state):
                if o is not s:
                    s.copy_(o)
        marks[:] = m
        return out, iou
    # no graph of this card left: the pool may have no holder
    fresh = all(k[-1] != key[-1] for k in _graphs)
    graph, (out, iou) = dev.capture(round_, fresh)
    changed = tuple(o is not s for o, s in zip(out, state))
    r = _Round(model, graph, state, changed, extra, out, iou, marks)
    _insert(key, r)
    rounds["captured"] += 1
    profiling.note_rounds("captured", 0)     # the replay that follows runs it
    return r


def _eager(dev: _Device, body: Callable, states, extra: Extra):
    """body(states, extra) on the capture stream; while a profiler
    records, with its stage marks, read at its end."""
    if not profiling.tracing():
        return dev.eager(lambda: body(states, extra))

    def marked():
        with profiling.stages(dev.event) as marks:
            out = body(states, extra)
        return out, marks
    out, marks = dev.eager(marked)
    profiling.read_stages(marks, "eager")
    return out


def _rounds(model, cfg, kind: str, body: Callable, states,
            extras: Iterable[Extra]) -> Tuple[object, torch.Tensor]:
    """One round of `body` per item of `extras` (a round's other inputs,
    made when the round is due): a key's first round eagerly, later ones
    replayed from its captured round (captured when there is none).
    Returns (the final states, fresh tensors; the rounds' ious stacked
    (B, rounds))."""
    device = states.image.device
    ious = []
    with _run(device) as dev:
        with profiling.span("graphs.prepare"):
            key = _key(model, cfg, kind, states)
            r = _lookup(key, model)
        loaded = False
        for extra in extras:
            with profiling.span("graphs.prepare"):
                first = r is None and _first_meeting(key)
                if r is not None:
                    r.read_marks()
                    if not loaded:
                        for s, t in zip(r.state, states):
                            s.copy_(t)
                    for k, v in r.extra.items():
                        v.copy_(extra[k])
            if first:
                with profiling.span("graphs.eager"):
                    states, iou = _eager(dev, body, states, extra)
                rounds["eager"] += 1
                profiling.note_rounds("eager")
                ious.append(iou)
                continue
            if r is None:
                with profiling.span("graphs.capture"):
                    r = _capture(model, key, dev, states, extra, body)
            loaded = True
            with profiling.span("graphs.replay"):
                r.graph.replay()
            r.unread = "profiled" if profiling.tracing() else "replayed"
            rounds["replayed"] += 1
            profiling.note_rounds("replayed")
            with profiling.span("graphs.finish"):
                ious.append(r.iou.clone())
        with profiling.span("graphs.finish"):
            if loaded:
                states = _pred.SessionState(*(
                    s.clone() if ch else t
                    for s, t, ch in zip(r.state, states, r.changed)))
            ious = torch.stack(ious, 1)
    return states, ious


def click_rounds(model, cfg, states, num_clicks: int,
                 gen: Optional[torch.Generator] = None):
    """`num_clicks` oracle rounds of a batch of sessions
    (`predictor.stack_states`; one session as `predictor._as_batch`):
    `predictor.batched_click_scan`, replayed on the card. Returns (final
    states, ious (B, num_clicks)). The prompt draws come from `gen` (None:
    a generator seeded NOISE_SEED), one per round, as the eager loop draws
    them."""
    device = states.image.device
    if not replayed(device):
        profiling.note_rounds("eager", num_clicks)
        return _pred.batched_click_scan(model, cfg, states, num_clicks, gen)
    if gen is None:
        gen = torch.Generator().manual_seed(_pred.NOISE_SEED)

    def draws():
        for _ in range(num_clicks):
            yield _pred._draw_noise(cfg, gen, device) or {}

    def body(st, noise):
        return _pred._click_step(model, cfg, st,
                                 noise if cfg.prompt_mode else None)
    return _rounds(model, cfg, "click", body, states, draws())


def user_click_round(model, cfg, state, y: float, x: float,
                     is_positive: bool):
    """One round of one session with a person's click:
    `predictor.user_click_step`, replayed on the card. Returns (new state,
    iou)."""
    device = state.image.device
    click = {"y": torch.full((), float(y), device=device),
             "x": torch.full((), float(x), device=device),
             "pos": torch.full((), bool(is_positive), dtype=torch.bool,
                               device=device)}
    if not replayed(device):
        profiling.note_rounds("eager")
        return _pred.user_click_step(model, cfg, state, click["y"],
                                     click["x"], click["pos"])

    def body(st, c):
        return _pred._user_click_step(model, cfg, st, c["y"], c["x"],
                                      c["pos"])
    states, ious = _rounds(model, cfg, "user", body, _pred._as_batch(state),
                           [click])
    return _pred.session(states, 0), ious[0, 0]
