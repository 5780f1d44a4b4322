"""Read the JAX package's self-describing `.npz` checkpoints without JAX.

The checkpoint (pvpuformer_tpu/utils/serialization.py) holds a JSON header
in `__header__` (uint8 bytes) and the parameter leaves under `params/<name>`,
where `<name>` is the `flatten_tree` path: dict keys joined by `/`, list
items as `#i` (`backbone/blocks/#3/attn/qkv/w`). The header's config uses
`__class__`, `__tuple__` and `__dtype__` encodings, which `config_from_dict`
reads back into this package's dataclasses of the same names.

All leaves keep their JAX layouts in the port ((in, out) linears, HWIO
convs, (in, 2, 2, out) deconvs), so `params_from_numpy` is a pure rename.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _registry() -> Dict[str, Any]:
    from ..inference.predictor import PredictorConfig
    from ..models.fpn import NeckConfig
    from ..models.seg_head import HeadConfig
    from ..models.two_way import TwoWayConfig
    from ..models.vit import ViTConfig
    from ..models.vpu import VPUConfig
    from ..ops.ppue import PPuEConfig
    classes = [ViTConfig, TwoWayConfig, NeckConfig, HeadConfig, VPUConfig,
               PPuEConfig, PredictorConfig]
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


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load_checkpoint(path) -> Tuple[Dict[str, np.ndarray], Any, int,
                                   Dict[str, Any]]:
    """Returns (flat params {flatten_tree name: array}, config, step, extra)."""
    with np.load(Path(path), allow_pickle=False) as z:
        header = json.loads(bytes(z["__header__"].tobytes()).decode())
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    cfg = header.get("config")
    config = config_from_dict(cfg) if cfg is not None else None
    return flat, config, int(header.get("step", 0)), dict(header.get("extra")
                                                           or {})


def torch_name(jax_name: str) -> str:
    """`backbone/blocks/#3/attn/qkv/w` -> `backbone.blocks.3.attn.qkv.w`."""
    return ".".join(p[1:] if p.startswith("#") else p
                    for p in jax_name.split("/"))


def params_from_numpy(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX leaves -> a state_dict for `VPUModel.load_state_dict`
    (strict loading refuses missing, extra or mis-shaped leaves). No leaf is
    transposed: the port keeps every JAX layout."""
    return {torch_name(name): _to_tensor(arr) for name, arr in flat.items()}
