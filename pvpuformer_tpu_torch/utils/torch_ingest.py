"""MAE-pretrained ViT weights -> the port's ViT parameters (the MAE part of
pvpuformer_tpu/utils/torch_ingest.py:24-121).

Covers the reference's pretrained-weight path
(`models_vit.py:150-166 init_weights_from_pretrained` over the MAE
checkpoints named in `config.yml:28-30`), with the bicubic pos-embed grid
interpolation of `pos_embed.py:75-96`.

The result is the JAX parameter tree of the ViT (numpy leaves), which
`serialization.params_from_numpy(flatten_tree(tree))` turns into the
backbone's state_dict (`load_vit_state`). Layouts:
  torch Linear (out, in)         -> (in, out)                [transpose]
  torch Conv2d (out, in, kh, kw) -> patch-embed matmul form (kh*kw*in, out)
  LayerNorm weight / bias        -> scale / bias
The reference VPU checkpoint, zoo and CLIP ingests are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.vit import ViTConfig
from .serialization import flatten_tree, params_from_numpy


def _t(x) -> np.ndarray:
    """torch tensor / numpy -> numpy f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A torch checkpoint's tensors (under "model" or "state_dict" when the
    file nests them), as f32 numpy arrays. Loads tensors only
    (`weights_only`): no code in the file runs."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    return {k: _t(v) for k, v in obj.items()}


def interpolate_pos_embed_np(pos_embed: np.ndarray,
                             src_grid: Tuple[int, int],
                             dst_grid: Tuple[int, int],
                             num_extra_tokens: int = 1) -> np.ndarray:
    """pos_embed (1, extra + gh*gw, D) -> (1, extra + gh'*gw', D), bicubic
    over the grid tokens only (pos_embed.py:88-96,117-124; torch 'bicubic',
    align_corners=False, in f64)."""
    if tuple(src_grid) == tuple(dst_grid):
        return pos_embed
    d = pos_embed.shape[-1]
    extra = pos_embed[:, :num_extra_tokens]
    grid = torch.from_numpy(np.asarray(pos_embed[:, num_extra_tokens:],
                                       np.float64))
    grid = grid.reshape(1, src_grid[0], src_grid[1], d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=tuple(dst_grid), mode="bicubic",
                         align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, dst_grid[0] * dst_grid[1], d)
    return np.concatenate([extra, grid.numpy().astype(np.float32)], axis=1)


def convert_vit_block(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    return {
        "norm1": {"scale": sd[f"{prefix}norm1.weight"],
                  "bias": sd[f"{prefix}norm1.bias"]},
        "attn": {
            "qkv": {"w": sd[f"{prefix}attn.qkv.weight"].T,
                    **({"b": sd[f"{prefix}attn.qkv.bias"]}
                       if f"{prefix}attn.qkv.bias" in sd else {})},
            "proj": {"w": sd[f"{prefix}attn.proj.weight"].T,
                     "b": sd[f"{prefix}attn.proj.bias"]},
        },
        "norm2": {"scale": sd[f"{prefix}norm2.weight"],
                  "bias": sd[f"{prefix}norm2.bias"]},
        "mlp": {"fc1": {"w": sd[f"{prefix}mlp.fc1.weight"].T,
                        "b": sd[f"{prefix}mlp.fc1.bias"]},
                "fc2": {"w": sd[f"{prefix}mlp.fc2.weight"].T,
                        "b": sd[f"{prefix}mlp.fc2.bias"]}},
    }


def conv_to_patch_embed(weight: np.ndarray, bias: np.ndarray) -> Dict[str, Any]:
    """Conv2d (out, in, kh, kw) -> {'w': (kh*kw*in, out), 'b': (out,)} in the
    (ph, pw, in) row-major order nn.patch_embed expects."""
    out_ch = weight.shape[0]
    w = weight.transpose(2, 3, 1, 0).reshape(-1, out_ch)
    return {"w": np.ascontiguousarray(w), "b": bias}


def convert_mae_vit(sd: Dict[str, np.ndarray], cfg: ViTConfig,
                    prefix: str = "") -> Dict[str, Any]:
    """MAE / reference ViT state dict -> the ViT's parameter tree, with the
    pos-embed grid interpolated to cfg.grid_size."""
    def k(name):
        return f"{prefix}{name}"

    pos = sd[k("pos_embed")]
    if pos.ndim == 2:
        pos = pos[None]
    src_side = int(round((pos.shape[1] - 1) ** 0.5))
    pos = interpolate_pos_embed_np(pos, (src_side, src_side), cfg.grid_size)
    return {
        "patch_embed": conv_to_patch_embed(sd[k("patch_embed.proj.weight")],
                                           sd[k("patch_embed.proj.bias")]),
        "pos_embed": pos,
        "cls_token": sd.get(k("cls_token"),
                            np.zeros((1, 1, cfg.embed_dim), np.float32)),
        "blocks": [convert_vit_block(sd, k(f"blocks.{i}."))
                   for i in range(cfg.depth)],
    }


def load_mae_pretrained(path, cfg: ViTConfig) -> Dict[str, Any]:
    """One-call ingest of an MAE .pth (config.yml:28-30 checkpoints)."""
    return convert_mae_vit(load_torch_state_dict(path), cfg)


def load_vit_state(vit: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Load a ViT parameter tree into the port's `ViT` module in place
    (strict: a missing, extra or mis-shaped leaf raises)."""
    vit.load_state_dict(params_from_numpy(flatten_tree(tree)))
