"""Read and write the JAX package's self-describing `.npz` checkpoints
without JAX.

The checkpoint (pvpuformer_tpu/utils/serialization.py) holds a JSON header
in `__header__` (uint8 bytes: config, step, extra, format) and the parameter
leaves under `params/<name>`, where `<name>` is the `flatten_tree` path:
dict keys joined by `/`, list items as `#i` (`backbone/blocks/#3/attn/qkv/w`).
The header's config uses `__class__`, `__tuple__` and `__dtype__`
encodings, which `config_from_dict` reads back into this package's
dataclasses of the same names and `config_to_dict` writes.

All leaves keep their JAX layouts in the port ((in, out) linears, HWIO
convs, (in, 2, 2, out) deconvs), so `params_from_numpy` is a pure rename.
`save_checkpoint` writes the same format, so JAX's `load_checkpoint` reads
the port's parameters and config; the torch optimizer state goes under
`torch_opt/`, which JAX's reader ignores (it reads only `opt/`).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}
FORMAT = "pvpuformer-tpu/ckpt/1"
OPT_PREFIX = "torch_opt/"


def _registry() -> Dict[str, Any]:
    from ..engine.train_step import TrainConfig
    from ..inference.predictor import PredictorConfig
    from ..models.fpn import NeckConfig
    from ..models.seg_head import HeadConfig
    from ..models.two_way import TwoWayConfig
    from ..models.vit import ViTConfig
    from ..models.registry import CONFIGS
    from ..models.zoo.clip_text import (ClipTextConfig, ClipViTConfig,
                                        ClipVisualConfig)
    from ..ops.ppue import PPuEConfig
    classes = [ViTConfig, TwoWayConfig, NeckConfig, HeadConfig, PPuEConfig,
               PredictorConfig, TrainConfig, *CONFIGS, ClipTextConfig,
               ClipVisualConfig, ClipViTConfig]
    return {c.__name__: c for c in classes}


def config_from_dict(d: Any) -> Any:
    """Decode a JAX checkpoint's config header into the port's dataclasses.
    Stored fields this version does not have are dropped; absent fields
    take the dataclass default (the JAX reader's version-skew rule)."""
    if isinstance(d, dict) and "__class__" in d:
        reg = _registry()
        if d["__class__"] not in reg:
            raise ValueError(f"config class {d['__class__']!r} is not ported")
        cls = reg[d["__class__"]]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: config_from_dict(v) for k, v in d.items()
                      if k != "__class__" and k in known})
    if isinstance(d, dict) and "__dtype__" in d:
        return _DTYPES[d["__dtype__"]]
    if isinstance(d, dict) and "__tuple__" in d:
        return tuple(config_from_dict(v) for v in d["__tuple__"])
    return d


def config_to_dict(cfg: Any) -> Any:
    """The port's config dataclasses -> the JAX header encoding."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        out = {"__class__": type(cfg).__name__}
        for f in dataclasses.fields(cfg):
            out[f.name] = config_to_dict(getattr(cfg, f.name))
        return out
    if isinstance(cfg, torch.dtype):
        return {"__dtype__": _DTYPE_NAMES[cfg]}
    if isinstance(cfg, (list, tuple)):
        return {"__tuple__": [config_to_dict(v) for v in cfg]}
    return cfg


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf for the file; bf16 is widened to f32 (numpy has no bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def load_checkpoint(path, opt_state: bool = False
                    ) -> Tuple[Dict[str, np.ndarray], Any, int,
                               Dict[str, Any]]:
    """Returns (flat params {flatten_tree name: array}, config, step, extra);
    with `opt_state`, extra["opt_state"] holds the port's optimizer state
    ({name: tensor}, empty for a file the JAX package wrote)."""
    with np.load(Path(path), allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"].tobytes()).decode())
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
        opt = {k[len(OPT_PREFIX):]: _to_tensor(z[k]) for k in z.files
               if k.startswith(OPT_PREFIX)} if opt_state else None
    cfg = header.get("config")
    config = config_from_dict(cfg) if cfg is not None else None
    extra = dict(header.get("extra") or {})
    if opt is not None:
        extra["opt_state"] = opt
    return flat, config, int(header.get("step", 0)), extra


def save_checkpoint(path, params: Dict[str, torch.Tensor], config: Any = None,
                    opt_state: Optional[Dict[str, torch.Tensor]] = None,
                    step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a checkpoint in the JAX format. `params` is a state_dict
    (`VPUModel.state_dict()`), `opt_state` a flat {name: tensor} (for
    example `TrainOptimizer.state_dict()`), stored under `torch_opt/`. The
    file is written beside the target and renamed over it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"params/{jax_name(k)}": _to_numpy(v) for k, v in params.items()}
    for k, v in (opt_state or {}).items():
        arrays[OPT_PREFIX + k] = _to_numpy(torch.as_tensor(v))
    header = {"config": config_to_dict(config) if config is not None
              else None, "step": int(step), "extra": extra or {},
              "format": FORMAT}
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         dtype=np.uint8)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)


def torch_name(jax_name: str) -> str:
    """`backbone/blocks/#3/attn/qkv/w` -> `backbone.blocks.3.attn.qkv.w`."""
    return ".".join(p[1:] if p.startswith("#") else p
                    for p in jax_name.split("/"))


def jax_name(name: str) -> str:
    """`backbone.blocks.3.attn.qkv.w` -> `backbone/blocks/#3/attn/qkv/w`."""
    return "/".join(f"#{p}" if p.isdigit() else p for p in name.split("."))


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict / list tree of arrays (the JAX parameter tree's shape)
    -> {flatten_tree name: array}, the names `params_from_numpy` reads."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def params_from_numpy(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX leaves -> a state_dict for `VPUModel.load_state_dict`
    (strict loading refuses missing, extra or mis-shaped leaves). No leaf is
    transposed: the port keeps every JAX layout."""
    return {torch_name(name): _to_tensor(arr) for name, arr in flat.items()}
