"""Model registry: config type -> (model class, forward)
(pvpuformer_tpu/models/registry.py).

Every family has the same surface: `Model(cfg, generator=None)` builds the
parameter tree of the JAX family's `init_*` (a zero tree for loading, seeded
random weights with a generator), and `forward(model, cfg, image
(B, H, W, 3|4), points (B, 2N, 3), **kw) -> {"instances", "instances_aux"}`.
The predictor, BRS, tiled inference and the CLIs dispatch on the config's
type. Every family is registered directly: a family that fails to import
fails here, not as a missing key later.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Type

import torch
from torch import nn as tnn

from .. import nn
from .plainvit import PlainVitConfig, PlainVitModel, plainvit_forward
from .vpu import VPUConfig, VPUModel, vpu_forward
from .zoo.deeplab import DeeplabISConfig, DeeplabISModel, deeplab_is_forward
from .zoo.hrformer import (HRFormerISConfig, HRFormerISModel,
                           hrformer_is_forward)
from .zoo.hrnet import HRNetISConfig, HRNetISModel, hrnet_is_forward
from .zoo.segformer import (SegformerISConfig, SegformerISModel,
                            segformer_is_forward)
from .zoo.swin import SwinISConfig, SwinISModel, swin_is_forward
from .zoo.swin_unet import (SwinUNetISConfig, SwinUNetISModel,
                            swin_unet_is_forward)

_REGISTRY: Dict[Type, Tuple[Type[tnn.Module], Callable]] = {
    VPUConfig: (VPUModel, vpu_forward),
    PlainVitConfig: (PlainVitModel, plainvit_forward),
    SegformerISConfig: (SegformerISModel, segformer_is_forward),
    HRNetISConfig: (HRNetISModel, hrnet_is_forward),
    DeeplabISConfig: (DeeplabISModel, deeplab_is_forward),
    SwinISConfig: (SwinISModel, swin_is_forward),
    HRFormerISConfig: (HRFormerISModel, hrformer_is_forward),
    SwinUNetISConfig: (SwinUNetISModel, swin_unet_is_forward),
}

CONFIGS = tuple(_REGISTRY)


def _entry(cfg) -> Tuple[Type[tnn.Module], Callable]:
    entry = _REGISTRY.get(type(cfg))
    if entry is None:
        raise KeyError(f"no model family is registered for "
                       f"{type(cfg).__name__}")
    return entry


def model_for(cfg) -> Type[tnn.Module]:
    """The family's module class."""
    return _entry(cfg)[0]


def forward_for(cfg) -> Callable:
    """The family's forward(model, cfg, image, points, **kw)."""
    return _entry(cfg)[1]


def crop_size(cfg) -> Optional[Tuple[int, int]]:
    """The crop a ViT-backed family (VPU, PlainVit) is built for, its
    backbone's `img_size`; None for a zoo family, which takes any size
    (DeepLab's `backbone` is the ResNet's name, not a ViT config)."""
    _entry(cfg)
    if isinstance(cfg, (VPUConfig, PlainVitConfig)):
        return tuple(cfg.backbone.img_size)
    return None


def build(cfg, generator: Optional[torch.Generator] = None,
          device=None) -> tnn.Module:
    """The family's module for `cfg`: seeded random weights with a
    `generator`, zeros without (for loading); built on the CPU and moved to
    `device` (None: the card)."""
    return model_for(cfg)(cfg, generator).to(nn.resolve_device(device))


def _adopt_conv_biases(model: tnn.Module, state) -> None:
    """Give a bias-free conv of `model` the bias `state` holds for it: the
    reference checkpoints carry torch conv biases in front of a BN (RITM's
    HRNet OCR convs) where the config's tree has none, and the JAX forward
    adds a conv's `b` wherever the tree has one. Any other leaf the module
    lacks is left for the strict load to refuse."""
    have = model.state_dict()
    modules = dict(model.named_modules())
    for name, t in state.items():
        if name in have or not name.endswith(".b"):
            continue
        owner = modules.get(name[:-2])
        if (isinstance(owner, nn.Conv) and owner.b is None
                and tuple(t.shape) == (owner.w.shape[-1],)):
            owner.b = nn.param(torch.zeros(t.shape, dtype=owner.w.dtype))


def load(flat, cfg) -> tnn.Module:
    """The family's module on the CPU with a checkpoint's flat leaves
    (`serialization.load_checkpoint`, or a converted reference checkpoint
    through `serialization.flatten_tree`), loaded strictly: missing, extra
    or mis-shaped leaves raise, except a bias of a bias-free conv, which
    the conv takes (`_adopt_conv_biases`)."""
    from ..utils.serialization import params_from_numpy
    model = model_for(cfg)(cfg)
    state = params_from_numpy(flat)
    _adopt_conv_biases(model, state)
    model.load_state_dict(state)
    return model
