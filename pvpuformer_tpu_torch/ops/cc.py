"""8-connected component labels and per-component maxima by bounded
flooding: kernel wrappers and plain versions (pvpuformer_tpu/ops/cc_pallas.py).

Both functions run exactly `iters` rounds of the flood: the masked 3x3
max-pool, then the segmented run-max along each row and along each column
(both directions, a run ends where the mask is False), masked again. A
component's label is the largest flat index r * W + c + 1 among its pixels,
0 is background. A component that needs more than `iters` rounds keeps
partial labels, exactly as the JAX kernels do (the bounded-round contract).

The CUDA kernels (csrc/cc.cu) run all rounds of a call in one cooperative
launch on the caller's stream (no host sync, no allocation, capturable in
a CUDA graph), take any B >= 1 and any H, W up to MAX_SIDE, and are
bit-identical to the plain versions, which repeat the JAX kernels' shifts
and log-step doubling on int32 tensors. Values must be non-negative (the
JAX kernels' contract); labels always are.

A launch's grid barrier is a word of the stream it runs on (`_slot`), so
calls on different streams may run concurrently. A CUDA graph keeps the
word of the stream it was captured on: replay it where no CC call on that
stream runs at the same time.
"""
from __future__ import annotations

import torch

from . import _build

MAX_SIDE = 8192        # labels r * W + c + 1 stay far inside int32


def _shift(x: torch.Tensor, d: int, axis: int, fill: int) -> torch.Tensor:
    """result[i] = x[i - d] along `axis` (d may be negative); `fill` pads."""
    n = x.shape[axis]
    pad_shape = list(x.shape)
    pad_shape[axis] = min(abs(d), n)
    pad = x.new_full(pad_shape, fill)
    if d > 0:
        return torch.cat([pad, x.narrow(axis, 0, n - pad_shape[axis])], axis)
    return torch.cat([x.narrow(axis, pad_shape[axis], n - pad_shape[axis]),
                      pad], axis)


def _segmented_run_max(lab: torch.Tensor, reset: torch.Tensor,
                       axis: int) -> torch.Tensor:
    """Max label within each run of not-reset elements along `axis`, by
    log-step segmented doubling in both directions (cc_pallas.py:44-65)."""
    n = lab.shape[axis]
    outs = []
    for direction in (1, -1):
        v, r = lab, reset
        d = 1
        while d < n:
            v_s = _shift(v, direction * d, axis, 0)
            r_s = _shift(r, direction * d, axis, 1)
            v = torch.where(r == 1, v, torch.maximum(v, v_s))
            r = torch.maximum(r, r_s)
            d *= 2
        outs.append(v)
    return torch.maximum(outs[0], outs[1])


def _flood(lab: torch.Tensor, masks: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` rounds of 8-connected max propagation over (B, H, W) masks."""
    reset = (~masks).to(torch.int32)
    for _ in range(iters):
        m1 = torch.maximum(lab, torch.maximum(_shift(lab, 1, 2, 0),
                                              _shift(lab, -1, 2, 0)))
        m2 = torch.maximum(m1, torch.maximum(_shift(m1, 1, 1, 0),
                                             _shift(m1, -1, 1, 0)))
        lab = torch.where(masks, m2, 0)
        lab = _segmented_run_max(lab, reset, axis=2)
        lab = _segmented_run_max(lab, reset, axis=1)
        lab = torch.where(masks, lab, 0)
    return lab


def cc_labels_plain(masks: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int32 component labels (0 = background)."""
    _, h, w = masks.shape
    idx = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=masks.device).view(h, w)
    return _flood(torch.where(masks, idx, 0), masks, iters)


def component_max_plain(masks: torch.Tensor, values: torch.Tensor,
                        iters: int = 8) -> torch.Tensor:
    """Per-component max of non-negative int32 `values` over each
    8-connected component of (B, H, W) `masks`; background reads 0."""
    return _flood(torch.where(masks, values.to(torch.int32), 0), masks, iters)


_slots: dict = {}      # (device index, stream handle) -> barrier word


def _slot(t: torch.Tensor, lib) -> int:
    """The barrier word of the current stream on t's device: its own for
    every stream, so no two concurrently running grids share one."""
    key = (t.device.index, _build.stream_of(t))
    if key not in _slots:
        taken = sum(k[0] == key[0] for k in _slots)
        if taken >= lib.pvpu_cc_barriers():
            raise RuntimeError(f"CC kernels: more than {taken} streams on "
                               f"device {key[0]}, no barrier word left")
        _slots[key] = taken
    return _slots[key]


def _checked(masks: torch.Tensor, iters: int, what: str) -> torch.Tensor:
    if masks.dtype != torch.bool or masks.dim() != 3:
        raise TypeError(f"{what}: (B, H, W) bool masks required, got "
                        f"{tuple(masks.shape)} {masks.dtype}")
    b, h, w = masks.shape
    if not (0 < h <= MAX_SIDE and 0 < w <= MAX_SIDE):
        raise ValueError(f"{what}: H, W must lie in (0, {MAX_SIDE}], got "
                         f"shape {tuple(masks.shape)}")
    if iters < 1:
        raise ValueError(f"{what}: the kernel runs iters >= 1 rounds, got "
                         f"{iters}")
    return masks.contiguous()


def cc_labels(masks: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """(B, H, W) bool -> int32 labels. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (one launch for all `iters` rounds)."""
    if masks.device.type != "cuda":
        return cc_labels_plain(masks, iters)
    m = _checked(masks, iters, "cc_labels")
    b, h, w = m.shape
    out = torch.empty(m.shape, dtype=torch.int32, device=m.device)
    scratch = torch.empty_like(out)
    lib = _build.library()
    _build.check(lib.pvpu_cc_labels(m.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), b, h, w, iters,
                                    _slot(m, lib), _build.stream_of(m)),
                 "cc_labels")
    cc_labels.launches += 1
    return out


def component_max(masks: torch.Tensor, values: torch.Tensor,
                  iters: int = 8) -> torch.Tensor:
    """Per-component max of non-negative int32 `values` (B, H, W). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (one
    launch)."""
    if masks.device.type != "cuda":
        return component_max_plain(masks, values, iters)
    m = _checked(masks, iters, "component_max")
    if values.dtype != torch.int32 or values.shape != m.shape:
        raise TypeError(f"component_max: int32 values of shape "
                        f"{tuple(m.shape)} required, got "
                        f"{tuple(values.shape)} {values.dtype}")
    b, h, w = m.shape
    v = values.contiguous()
    out = torch.empty_like(v)
    scratch = torch.empty_like(v)
    lib = _build.library()
    _build.check(lib.pvpu_component_max(m.data_ptr(), v.data_ptr(),
                                        out.data_ptr(), scratch.data_ptr(),
                                        b, h, w, iters, _slot(m, lib),
                                        _build.stream_of(m)),
                 "component_max")
    component_max.launches += 1
    return out


cc_labels.launches = 0
component_max.launches = 0
