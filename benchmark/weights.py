"""Seeded weights of the VPU, drawn on the device in the dtype they are
served in, with the program's init families (xavier / kaiming uniform,
normal, constants), in the layout the program loads (its state_dict names).

`draw` yields the values chunk by chunk, each chunk from three large calls
on a device generator (a uniform draw, a normal draw, one fused affine
map of them), so that the same seed gives the same values whoever asks:
the program's parameters are filled from it at set-up, and the plain
reference draws them again after the window.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

CHUNK = 1 << 26                       # elements per draw

Spec = Tuple[str, Tuple[int, ...]]

_XAVIER = re.compile(r"^backbone\.(blocks\.\d+\.(attn\.(qkv|proj)|mlp\.fc[12])"
                     r"|patch_embed)\.w$")
_XAVIER_ZERO_BIAS = re.compile(r"^backbone\.blocks\.\d+\.(attn\.(qkv|proj)"
                               r"|mlp\.fc[12])\.b$")
_NORMAL = {"backbone.pos_embed": 0.02, "backbone.cls_token": 0.02,
           "pe_gaussian": 1.0, "point_embeddings": 1.0,
           "not_a_point_embed": 1.0}
_CONST = {"head.logit_scale": math.log(1.0 / 0.07)}


def _fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """The fan-in of the container of `name` (a `.w` or `.b` leaf)."""
    w = shapes[name.rsplit(".", 1)[0] + ".w"]
    if ".deconv" in name:                 # ConvTranspose2d: (in, 2, 2, out)
        return w[-1] * 4
    return math.prod(w[:-1])


def leaf_init(name: str, shapes: Dict[str, Tuple[int, ...]]
              ) -> Tuple[float, float, float]:
    """(a, b, c) of a leaf: value = a * u + b * z + c, u uniform [0, 1),
    z standard normal."""
    shape = shapes[name]
    if name in _CONST:
        return 0.0, 0.0, _CONST[name]
    if name in _NORMAL:
        return 0.0, _NORMAL[name], 0.0
    if name.endswith(".scale"):
        return 0.0, 0.0, 1.0
    if name.endswith(".bias") or _XAVIER_ZERO_BIAS.match(name):
        return 0.0, 0.0, 0.0
    if _XAVIER.match(name):
        bound = math.sqrt(6.0 / (math.prod(shape[:-1]) + shape[-1]))
    elif name.endswith(".w"):
        bound = math.sqrt(3.0 / _fan_in(name, shapes))
    elif name.endswith(".b"):
        bound = math.sqrt(1.0 / _fan_in(name, shapes))
    else:
        raise KeyError(f"no init family for {name} {shape}")
    return 2.0 * bound, 0.0, -bound


def _chunks(specs: Sequence[Spec]) -> Iterator[List[Spec]]:
    group, size = [], 0
    for name, shape in specs:
        n = math.prod(shape)
        if group and size + n > CHUNK:
            yield group
            group, size = [], 0
        group.append((name, shape))
        size += n
    if group:
        yield group


@torch.no_grad()
def draw(specs: Sequence[Spec], seed: int, device, dtype: torch.dtype
         ) -> Iterator[Tuple[List[str], List[torch.Tensor]]]:
    """(names, values) per chunk, the values in `dtype` on `device`."""
    shapes = dict(specs)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for group in _chunks(specs):
        counts = torch.tensor([math.prod(s) for _, s in group],
                              device=device)
        coef = torch.tensor([leaf_init(n, shapes) for n, _ in group],
                            dtype=torch.float32, device=device)
        a, b, c = (torch.repeat_interleave(coef[:, i], counts)
                   for i in range(3))
        u = torch.rand(a.shape, generator=gen, device=device)
        z = torch.randn(a.shape, generator=gen, device=device)
        flat = (a * u + b * z + c).to(dtype)
        values = torch.split(flat, counts.tolist())
        yield ([n for n, _ in group],
               [v.view(s) for v, (_, s) in zip(values, group)])


def specs_of(model: torch.nn.Module) -> List[Spec]:
    return [(n, tuple(t.shape)) for n, t in model.state_dict().items()]


def fill(model: torch.nn.Module, seed: int) -> List[Spec]:
    """Draw every state_dict leaf of `model` from `seed` into it, on its
    device and in its dtype. Returns the specs the draw followed."""
    specs = specs_of(model)
    state = model.state_dict()
    first = next(iter(state.values()))
    for names, values in draw(specs, seed, first.device, first.dtype):
        torch._foreach_copy_([state[n] for n in names], values)
    return specs


def reference_params(specs: Sequence[Spec], seed: int, device,
                     dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The same values as `fill` gave the program, as float32."""
    out = {}
    for names, values in draw(specs, seed, device, dtype):
        out.update((n, v.float()) for n, v in zip(names, values))
    return out
