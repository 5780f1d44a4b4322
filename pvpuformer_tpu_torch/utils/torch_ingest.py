"""Reference torch checkpoints -> the port's parameter trees
(pvpuformer_tpu/utils/torch_ingest.py).

Covers the reference's pretrained-weight path
(`models_vit.py:150-166 init_weights_from_pretrained` over the MAE
checkpoints named in `config.yml:28-30`), with the bicubic pos-embed grid
interpolation of `pos_embed.py:75-96`, and the converters of whole
published models:
  * `convert_vpu_checkpoint` / `load_vpu_checkpoint`: the reference
    PVPUFormer (VitMultiGaussianVector_ed_Model) weights;
  * `convert_plainvit_checkpoint`: SimpleClick (PlainVitModel);
  * `convert_hrnet_checkpoint`, `convert_deeplab_checkpoint`: the RITM zoo;
  * `convert_mit_backbone` (mmseg) / `convert_mit_official` (NVlabs),
    `convert_swin_backbone`: SegFormer and Swin backbones;
  * `convert_hrformer_checkpoint`: HRFormer (HRT_B_OCR_V3);
  * `convert_clip_resnet`, `convert_clip_vit`, `convert_clip_text`: the
    CLIP visual towers and text encoder (`models/zoo/clip_text.py`),
    loaded strictly by `load_clip`.

Each returns the JAX package's nested tree with numpy leaves, bit for bit.
`serialization.flatten_tree` flattens it and `models.registry.load` loads
it strictly into the family's module (a torch conv's bias in front of a
BN, which RITM's HRNet checkpoints carry, becomes that conv's bias; the
JAX forward adds it too). Identity transitions and fuse entries are `{}`
and have no leaves; the module built from the config keeps their places.
Layouts:
  torch Linear (out, in)            -> (in, out)                [transpose]
  torch Conv2d (out, in, kh, kw)    -> HWIO (kh, kw, in, out); the patch
                                       embeds -> (kh*kw*in, out)
  torch ConvTranspose2d (in, out, 2, 2) -> (in, 2, 2, out)
  LayerNorm / GroupNorm weight, bias -> scale, bias
  BatchNorm2d                        -> scale, bias, mean, var
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.vit import ViTConfig
from ..models.zoo.deeplab import RESNET_SPECS
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


# ---------------------------------------------------------------------------
# reference VPU checkpoint ingest (VitMultiGaussianVector_ed_Model)
# ---------------------------------------------------------------------------

def _lin(sd, name) -> Dict[str, np.ndarray]:
    p = {"w": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _gn(sd, name) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _conv(sd, name) -> Dict[str, np.ndarray]:
    """Conv2d (out,in,kh,kw) -> HWIO."""
    p = {"w": np.ascontiguousarray(sd[f"{name}.weight"].transpose(2, 3, 1, 0))}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _deconv(sd, name) -> Dict[str, np.ndarray]:
    """ConvTranspose2d (in,out,2,2) -> our (in, 2, 2, out) matmul form."""
    p = {"w": np.ascontiguousarray(sd[f"{name}.weight"].transpose(0, 2, 3, 1))}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _attn(sd, name) -> Dict[str, Any]:
    """transformer.py Attention (q/k/v/out_proj Linears, :466-521)."""
    return {"q": _lin(sd, f"{name}.q_proj"), "k": _lin(sd, f"{name}.k_proj"),
            "v": _lin(sd, f"{name}.v_proj"),
            "out": _lin(sd, f"{name}.out_proj")}


def convert_vpu_checkpoint(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """Reference VitMultiGaussianVector_ed_Model state dict -> our params.

    Name map (reference modules at is_vpu_model.py:165-186, SimpleFPN at
    18-91, TwoWayTransformer at transformer.py:222-427, head at
    swin_transformer.py:655-722). `cfg` is our VPUConfig (for the ViT grid).
    Enables bit-comparable evaluation against reference weights.
    """
    params: Dict[str, Any] = {
        "backbone": convert_mae_vit(sd, cfg.backbone, prefix="backbone."),
        "patch_embed_coords": conv_to_patch_embed(
            sd["patch_embed_coords.proj.weight"],
            sd["patch_embed_coords.proj.bias"]),
        "pe_gaussian": sd["pe_layer.positional_encoding_gaussian_matrix"],
        "point_embeddings": np.stack(
            [sd[f"point_embeddings.{i}.weight"][0] for i in range(4)]),
        "not_a_point_embed": sd["not_a_point_embed.weight"],
    }

    # --- neck (SimpleFPN, is_vpu_model.py:18-91) ---
    layers = []
    depth = 0
    while f"neck.att.layers.{depth}.norm1.weight" in sd:
        depth += 1
    for i in range(depth):
        b = f"neck.att.layers.{i}"
        layers.append({
            "self_attn": _attn(sd, f"{b}.self_attn"),
            "norm1": _gn(sd, f"{b}.norm1"),
            "cross_t2i": _attn(sd, f"{b}.cross_attn_token_to_image"),
            "norm2": _gn(sd, f"{b}.norm2"),
            "mlp": {"fc1": _lin(sd, f"{b}.mlp.lin1"),
                    "fc2": _lin(sd, f"{b}.mlp.lin2")},
            "norm3": _gn(sd, f"{b}.norm3"),
            "cross_i2t": _attn(sd, f"{b}.cross_attn_image_to_token"),
            "norm4": _gn(sd, f"{b}.norm4"),
        })
    params["neck"] = {
        "ffn": {"fc1": _lin(sd, "neck.ffn_layer.lin1"),
                "fc2": _lin(sd, "neck.ffn_layer.lin2")},
        "att": {"layers": layers,
                "final_t2i": _attn(sd, "neck.att.final_attn_token_to_image"),
                "norm_final": _gn(sd, "neck.att.norm_final_attn")},
        # Sequential indices: is_vpu_model.py:56-86
        "down4": {"deconv1": _deconv(sd, "neck.down_4.0"),
                  "gn1": _gn(sd, "neck.down_4.1"),
                  "deconv2": _deconv(sd, "neck.down_4.3"),
                  "gn2": _gn(sd, "neck.down_4.4"),
                  "conv": _conv(sd, "neck.down_4.5"),
                  "gn3": _gn(sd, "neck.down_4.6")},
        "down8": {"deconv": _deconv(sd, "neck.down_8.0"),
                  "gn1": _gn(sd, "neck.down_8.1"),
                  "conv": _conv(sd, "neck.down_8.2"),
                  "gn2": _gn(sd, "neck.down_8.3")},
        "down16": {"conv": _conv(sd, "neck.down_16.0"),
                   "gn": _gn(sd, "neck.down_16.1")},
        "down32": {"conv1": _conv(sd, "neck.down_32.0"),
                   "gn1": _gn(sd, "neck.down_32.1"),
                   "conv2": _conv(sd, "neck.down_32.2"),
                   "gn2": _gn(sd, "neck.down_32.3")},
    }

    # --- head (SwinTransfomerSegHead, swin_transformer.py:655-722) ---
    n_scales = len(cfg.head.in_channels)
    head: Dict[str, Any] = {
        "convs": [_conv(sd, f"head.convs.{i}.conv")
                  for i in range(n_scales)],
        "fusion": _conv(sd, "head.fusion_conv.conv"),
        "conv_seg": _conv(sd, "head.conv_seg"),
    }
    if "head.up_conv1.0.weight" in sd:
        head["up1"] = {"deconv": _deconv(sd, "head.up_conv1.0"),
                       "gn1": _gn(sd, "head.up_conv1.1"),
                       "conv": _conv(sd, "head.up_conv1.2"),
                       "gn2": _gn(sd, "head.up_conv1.3")}
    if "head.up_conv2.0.weight" in sd:
        head["up2"] = {"deconv": _deconv(sd, "head.up_conv2.0"),
                       "gn1": _gn(sd, "head.up_conv2.1"),
                       "conv": _conv(sd, "head.up_conv2.2"),
                       "gn2": _gn(sd, "head.up_conv2.3")}
    if "head.logit_scale" in sd:
        head["logit_scale"] = sd["head.logit_scale"]
        head["ffn"] = {"fc1": _lin(sd, "head.ffn_layer.lin1"),
                       "fc2": _lin(sd, "head.ffn_layer.lin2")}
    params["head"] = head

    if "head_aux.weight" in sd:
        params["head_aux"] = _conv(sd, "head_aux")
    return params


def load_vpu_checkpoint(path, cfg) -> Dict[str, Any]:
    """One-call ingest of a reference VPU .pth ({state_dict, config})."""
    return convert_vpu_checkpoint(load_torch_state_dict(path), cfg)


def _bn(sd, name) -> Dict[str, np.ndarray]:
    """BatchNorm2d -> frozen-BN params (zoo/common.py)."""
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"],
            "mean": sd[f"{name}.running_mean"],
            "var": sd[f"{name}.running_var"]}


def _conv_bn(sd, conv_name, bn_name) -> Dict[str, Any]:
    return {"conv": _conv(sd, conv_name), "bn": _bn(sd, bn_name)}


def convert_hrnet_checkpoint(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """RITM HRNetModel state dict -> our hrnet params (zoo/hrnet.py).

    Name map over `isegm/model/modeling/hrnet_ocr.py` (stem conv1/bn1 +
    conv2/bn2, layer1 BottleneckV1b, transition{1..3}, stage{2..4} modules
    with branches/fuse_layers, conv3x3_ocr + aux_head + SpatialOCR at
    ocr.py:30-141) and ISModel's maps_transform (is_model.py:28-36).
    `cfg` is a zoo.hrnet.HRNetISConfig matching the checkpoint's
    width/small/ocr_width.
    """
    fx = "feature_extractor."

    def block_basic(prefix):
        return {"c1": _conv_bn(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
                "c2": _conv_bn(sd, f"{prefix}.conv2", f"{prefix}.bn2")}

    def block_bottleneck(prefix):
        p = {"c1": _conv_bn(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
             "c2": _conv_bn(sd, f"{prefix}.conv2", f"{prefix}.bn2"),
             "c3": _conv_bn(sd, f"{prefix}.conv3", f"{prefix}.bn3")}
        if f"{prefix}.downsample.0.weight" in sd:
            p["down"] = _conv_bn(sd, f"{prefix}.downsample.0",
                                 f"{prefix}.downsample.1")
        return p

    def transition(tname, n_new_widths):
        out = []
        for i in range(n_new_widths):
            base = f"{fx}{tname}.{i}"
            if f"{base}.0.0.weight" in sd:          # new branch (nested Seq)
                out.append({"new": _conv_bn(sd, f"{base}.0.0", f"{base}.0.1")})
            elif f"{base}.0.weight" in sd:          # channel adapter
                out.append(_conv_bn(sd, f"{base}.0", f"{base}.1"))
            else:                                   # identity (None in torch)
                out.append({})
        return out

    def module(prefix, nb, blocks):
        p: Dict[str, Any] = {"branches": [], "fuse": []}
        for b in range(nb):
            p["branches"].append([
                block_basic(f"{prefix}.branches.{b}.{j}")
                for j in range(blocks)])
        for i in range(nb):
            row = []
            for j in range(nb):
                f = f"{prefix}.fuse_layers.{i}.{j}"
                if j > i:
                    row.append({"up": _conv_bn(sd, f"{f}.0", f"{f}.1")})
                elif j < i:
                    chain = []
                    for k in range(i - j):
                        chain.append(_conv_bn(sd, f"{f}.{k}.0", f"{f}.{k}.1"))
                    row.append({"downs": chain})
                else:
                    row.append({})
            p["fuse"].append(row)
        return p

    w = cfg.branch_widths
    nm = cfg.num_modules
    blocks = cfg.blocks_per_module
    ocr = {
        "conv3x3": _conv_bn(sd, f"{fx}conv3x3_ocr.0", f"{fx}conv3x3_ocr.1"),
        "aux": {"c1": _conv_bn(sd, f"{fx}aux_head.0", f"{fx}aux_head.1"),
                "cls": _conv(sd, f"{fx}aux_head.3")},
        "f_pixel": [
            _conv_bn(sd, f"{fx}ocr_distri_head.object_context_block.f_pixel.0",
                     f"{fx}ocr_distri_head.object_context_block.f_pixel.1.0"),
            _conv_bn(sd, f"{fx}ocr_distri_head.object_context_block.f_pixel.2",
                     f"{fx}ocr_distri_head.object_context_block.f_pixel.3.0")],
        "f_object": [
            _conv_bn(sd, f"{fx}ocr_distri_head.object_context_block.f_object.0",
                     f"{fx}ocr_distri_head.object_context_block.f_object.1.0"),
            _conv_bn(sd, f"{fx}ocr_distri_head.object_context_block.f_object.2",
                     f"{fx}ocr_distri_head.object_context_block.f_object.3.0")],
        "f_down": _conv_bn(
            sd, f"{fx}ocr_distri_head.object_context_block.f_down.0",
            f"{fx}ocr_distri_head.object_context_block.f_down.1.0"),
        "f_up": _conv_bn(
            sd, f"{fx}ocr_distri_head.object_context_block.f_up.0",
            f"{fx}ocr_distri_head.object_context_block.f_up.1.0"),
        "bottleneck": _conv_bn(sd, f"{fx}ocr_distri_head.conv_bn_dropout.0",
                               f"{fx}ocr_distri_head.conv_bn_dropout.1.0"),
        "cls": _conv(sd, f"{fx}cls_head"),
    }
    return {
        "maps_transform": {"conv1": _conv(sd, "maps_transform.0"),
                           "conv2": _conv(sd, "maps_transform.2"),
                           # ScaleLayer applies abs(scale * lr_mult) at
                           # forward time (ops.py:393-395); lr_mult=1 here
                           "scale": np.abs(
                               sd["maps_transform.3.scale"]).reshape(())},
        "stem1": _conv_bn(sd, f"{fx}conv1", f"{fx}bn1"),
        "stem2": _conv_bn(sd, f"{fx}conv2", f"{fx}bn2"),
        "layer1": [block_bottleneck(f"{fx}layer1.{j}")
                   for j in range(blocks)],
        "tr1": transition("transition1", 2),
        "stage2": [module(f"{fx}stage2.{m}", 2, blocks) for m in range(nm[0])],
        "tr2": transition("transition2", 3),
        "stage3": [module(f"{fx}stage3.{m}", 3, blocks) for m in range(nm[1])],
        "tr3": transition("transition3", 4),
        "stage4": [module(f"{fx}stage4.{m}", 4, blocks) for m in range(nm[2])],
        "ocr": ocr,
    }


def convert_hrformer_checkpoint(sd: Dict[str, np.ndarray],
                                cfg) -> Dict[str, Any]:
    """HRT_B_OCR_V3 state dict (`modeling/hrformer.py:55-110` over
    `hrformer_helper/hrt/hrt_backbone.py`) -> our zoo/hrformer params.

    Expects HRT_B_OCR_V3-level keys (`backbone.*` + `conv3x3/aux_head/
    ocr_distri_head/cls_head`); for a full HRFormerModel checkpoint strip
    the `feature_extractor.` prefix first. `cfg` is a HRFormerISConfig
    matching the checkpoint's width/heads/modules.
    """
    bb = "backbone."

    def block(prefix):
        """GeneralTransformerBlock (transformer_block.py:52-96)."""
        a = f"{prefix}.attn.attn"
        m = f"{prefix}.mlp"
        return {
            "norm1": _gn(sd, f"{prefix}.norm1"),
            "attn": {"q": _lin(sd, f"{a}.q_proj"),
                     "k": _lin(sd, f"{a}.k_proj"),
                     "v": _lin(sd, f"{a}.v_proj"),
                     "out": _lin(sd, f"{a}.out_proj"),
                     "rpe": sd[f"{a}.relative_position_bias_table"]},
            "norm2": _gn(sd, f"{prefix}.norm2"),
            "mlp": {"fc1": _conv_bn(sd, f"{m}.fc1", f"{m}.norm1"),
                    "dw": _conv_bn(sd, f"{m}.dw3x3", f"{m}.norm2"),
                    "fc2": _conv_bn(sd, f"{m}.fc2", f"{m}.norm3")},
        }

    def block_bottleneck(prefix):
        p = {"c1": _conv_bn(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
             "c2": _conv_bn(sd, f"{prefix}.conv2", f"{prefix}.bn2"),
             "c3": _conv_bn(sd, f"{prefix}.conv3", f"{prefix}.bn3")}
        if f"{prefix}.downsample.0.weight" in sd:
            p["down"] = _conv_bn(sd, f"{prefix}.downsample.0",
                                 f"{prefix}.downsample.1")
        return p

    def transition(tname, n_new):
        out = []
        for i in range(n_new):
            base = f"{bb}{tname}.{i}"
            if f"{base}.0.0.weight" in sd:          # new branch (nested Seq)
                out.append({"new": _conv_bn(sd, f"{base}.0.0",
                                            f"{base}.0.1")})
            elif f"{base}.0.weight" in sd:          # channel adapter
                out.append(_conv_bn(sd, f"{base}.0", f"{base}.1"))
            else:
                out.append({})
        return out

    def module(prefix, nb, blocks):
        """hrt_backbone.py:24-303: transformer branches + DW-separable
        fuse (down: [.k.0 dw, .k.1 bn, .k.2 pw, .k.3 bn]; up: [.0 1x1,
        .1 bn, .2 nearest-Upsample])."""
        p: Dict[str, Any] = {"branches": [], "fuse": []}
        for b in range(nb):
            p["branches"].append([
                block(f"{prefix}.branches.{b}.{j}") for j in range(blocks)])
        for i in range(nb):
            row = []
            for j in range(nb):
                f = f"{prefix}.fuse_layers.{i}.{j}"
                if j > i:
                    row.append({"up": _conv_bn(sd, f"{f}.0", f"{f}.1")})
                elif j < i:
                    chain = []
                    for k in range(i - j):
                        chain.append(
                            {"dw": _conv_bn(sd, f"{f}.{k}.0", f"{f}.{k}.1"),
                             "pw": _conv_bn(sd, f"{f}.{k}.2", f"{f}.{k}.3")})
                    row.append({"downs": chain})
                else:
                    row.append({})
            p["fuse"].append(row)
        return p

    nm = cfg.num_units
    blocks = cfg.blocks_per_unit
    oc = "ocr_distri_head.object_context_block"
    ocr = None if "conv3x3.0.weight" not in sd else {
        "conv3x3": {"conv": _conv(sd, "conv3x3.0"),
                    "bn": _bn(sd, "conv3x3.1.0")},
        "aux1": {"conv": _conv(sd, "aux_head.0"),
                 "bn": _bn(sd, "aux_head.1.0")},
        "aux_cls": _conv(sd, "aux_head.2"),
        "f_pixel": [_conv_bn(sd, f"{oc}.f_pixel.0", f"{oc}.f_pixel.1.0"),
                    _conv_bn(sd, f"{oc}.f_pixel.2", f"{oc}.f_pixel.3.0")],
        "f_object": [_conv_bn(sd, f"{oc}.f_object.0", f"{oc}.f_object.1.0"),
                     _conv_bn(sd, f"{oc}.f_object.2", f"{oc}.f_object.3.0")],
        "f_down": _conv_bn(sd, f"{oc}.f_down.0", f"{oc}.f_down.1.0"),
        "f_up": _conv_bn(sd, f"{oc}.f_up.0", f"{oc}.f_up.1.0"),
        "bottleneck": _conv_bn(sd, "ocr_distri_head.conv_bn_dropout.0",
                               "ocr_distri_head.conv_bn_dropout.1.0"),
        "cls": _conv(sd, "cls_head"),
    }
    params = {
        "stem1": _conv_bn(sd, f"{bb}conv1", f"{bb}bn1"),
        "stem2": _conv_bn(sd, f"{bb}conv2", f"{bb}bn2"),
        "layer1": [block_bottleneck(f"{bb}layer1.{j}") for j in range(2)],
        "tr1": transition("transition1", 2),
        "stage2": [module(f"{bb}stage2.{m}", 2, blocks)
                   for m in range(nm[0])],
        "tr2": transition("transition2", 3),
        "stage3": [module(f"{bb}stage3.{m}", 3, blocks)
                   for m in range(nm[1])],
        "tr3": transition("transition3", 4),
        "stage4": [module(f"{bb}stage4.{m}", 4, blocks)
                   for m in range(nm[2])],
    }
    if ocr is not None:
        params["ocr"] = ocr
    return params


def convert_deeplab_checkpoint(sd: Dict[str, np.ndarray],
                               cfg) -> Dict[str, Any]:
    """RITM DeeplabModel state dict -> our zoo/deeplab params.

    Name map over `is_deeplab_model.py:10-27` / `deeplab_v3.py:12-176` /
    `resnetv1b.py`: feature_extractor.backbone (deep stem Sequential or 7x7
    conv1 + bn1, layer1..4 with downsample.0/.1), feature_extractor.aspp
    (concurent.0..4 + project), feature_extractor.skip_project,
    feature_extractor.head (_DeepLabHead SeparableConv2d block) and the
    outer SepConvHead `head.layers`. `cfg` is a DeeplabISConfig matching
    the checkpoint's backbone/ch.
    """
    layers_per, block, stem = RESNET_SPECS[cfg.backbone]
    bb = "feature_extractor.backbone."

    def sep(prefix):
        """SeparableConv2d.body = Sequential(dw, pw, bn, relu)."""
        return {"dw": _conv(sd, f"{prefix}.body.0"),
                "pw": _conv(sd, f"{prefix}.body.1"),
                "bn": _bn(sd, f"{prefix}.body.2")}

    def res_block(prefix):
        p = {"c1": _conv_bn(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
             "c2": _conv_bn(sd, f"{prefix}.conv2", f"{prefix}.bn2")}
        if f"{prefix}.conv3.weight" in sd:
            p["c3"] = _conv_bn(sd, f"{prefix}.conv3", f"{prefix}.bn3")
        if f"{prefix}.downsample.0.weight" in sd:
            p["down"] = _conv_bn(sd, f"{prefix}.downsample.0",
                                 f"{prefix}.downsample.1")
        return p

    params: Dict[str, Any] = {
        "maps_transform": {"conv1": _conv(sd, "maps_transform.0"),
                           "conv2": _conv(sd, "maps_transform.2"),
                           "scale": np.abs(
                               sd["maps_transform.3.scale"]).reshape(())},
    }
    if stem == "deep":
        params["stem"] = [
            _conv_bn(sd, f"{bb}conv1.0", f"{bb}conv1.1"),
            _conv_bn(sd, f"{bb}conv1.3", f"{bb}conv1.4"),
            _conv_bn(sd, f"{bb}conv1.6", f"{bb}bn1"),
        ]
    else:
        params["stem"] = [_conv_bn(sd, f"{bb}conv1", f"{bb}bn1")]
    for i, n in enumerate(layers_per, start=1):
        params[f"layer{i}"] = [res_block(f"{bb}layer{i}.{j}")
                               for j in range(n)]

    fe = "feature_extractor."
    params["aspp"] = {
        "b0": _conv_bn(sd, f"{fe}aspp.concurent.0.0", f"{fe}aspp.concurent.0.1"),
        "b1": _conv_bn(sd, f"{fe}aspp.concurent.1.0", f"{fe}aspp.concurent.1.1"),
        "b2": _conv_bn(sd, f"{fe}aspp.concurent.2.0", f"{fe}aspp.concurent.2.1"),
        "b3": _conv_bn(sd, f"{fe}aspp.concurent.3.0", f"{fe}aspp.concurent.3.1"),
        "pool": _conv_bn(sd, f"{fe}aspp.concurent.4.gap.1",
                         f"{fe}aspp.concurent.4.gap.2"),
        "project": _conv_bn(sd, f"{fe}aspp.project.0", f"{fe}aspp.project.1"),
    }
    params["skip"] = _conv_bn(sd, f"{fe}skip_project.skip_project.0",
                              f"{fe}skip_project.skip_project.1")
    params["dhead"] = {"sep1": sep(f"{fe}head.block.0"),
                       "sep2": sep(f"{fe}head.block.1"),
                       "cls": _conv(sd, f"{fe}head.block.2")}
    params["head"] = {"sep1": sep("head.layers.0"),
                      "sep2": sep("head.layers.1"),
                      "cls": _conv(sd, "head.layers.2")}
    return params


def convert_mit_backbone(sd: Dict[str, np.ndarray], cfg,
                         prefix: str = "") -> Dict[str, Any]:
    """mmseg MixVisionTransformer (mit-b*) weights -> zoo/segformer stages.

    Name map over the reference's mmseg-style backbone
    (`isegm/model/modeling/segformer.py:336-366`):
      layers.{i}.0.projection/.norm     overlap patch embed
      layers.{i}.1.{j}.norm1/.attn.attn.in_proj_*/.attn.attn.out_proj/
                      .attn.sr/.attn.norm/.norm2/.ffn.layers.{0,1,4}
      layers.{i}.2                      stage-final LN
    The stage-1 patch conv extends from 3 input channels to 3+coord_ch by
    duplicating channels (the reference's "v3" weight surgery,
    segformer.py:399-404). Returns {"stages": [...]} matching
    init_segformer_is; head params are trained from scratch (mit releases
    are backbone-only).
    """
    def k(n):
        return f"{prefix}{n}"

    coord_ch = 3 if cfg.with_prev_mask else 2
    stages = []
    for i in range(len(cfg.embed_dims)):
        base = k(f"layers.{i}")
        pw = sd[f"{base}.0.projection.weight"]        # (out, in, kh, kw)
        pb = sd[f"{base}.0.projection.bias"]
        if i == 0 and pw.shape[1] == 3 and coord_ch > 0:
            extra = pw[:, :coord_ch]
            pw = np.concatenate([pw, extra], axis=1)  # v3 channel surgery
        d = pw.shape[0]
        blocks = []
        j = 0
        while f"{base}.1.{j}.norm1.weight" in sd:
            b = f"{base}.1.{j}"
            in_w = sd[f"{b}.attn.attn.in_proj_weight"]       # (3D, D)
            in_b = sd[f"{b}.attn.attn.in_proj_bias"]
            blk = {
                "norm1": _gn(sd, f"{b}.norm1"),
                "q": {"w": in_w[:d].T, "b": in_b[:d]},
                "kv": {"w": in_w[d:].T, "b": in_b[d:]},
                "proj": _lin(sd, f"{b}.attn.attn.out_proj"),
                "norm2": _gn(sd, f"{b}.norm2"),
                "fc1": {"w": sd[f"{b}.ffn.layers.0.weight"][:, :, 0, 0].T,
                        "b": sd[f"{b}.ffn.layers.0.bias"]},
                "dw": {"w": np.ascontiguousarray(
                    sd[f"{b}.ffn.layers.1.weight"].transpose(2, 3, 1, 0)),
                    "b": sd[f"{b}.ffn.layers.1.bias"]},
                "fc2": {"w": sd[f"{b}.ffn.layers.4.weight"][:, :, 0, 0].T,
                        "b": sd[f"{b}.ffn.layers.4.bias"]},
            }
            if f"{b}.attn.sr.weight" in sd:
                blk["sr"] = _conv(sd, f"{b}.attn.sr")
                blk["sr_norm"] = _gn(sd, f"{b}.attn.norm")
            blocks.append(blk)
            j += 1
        stages.append({
            "patch": {"w": np.ascontiguousarray(pw.transpose(2, 3, 1, 0)),
                      "b": pb},
            "patch_norm": _gn(sd, f"{base}.0.norm"),
            "blocks": blocks,
            "norm": _gn(sd, f"{base}.2"),
        })
    return {"stages": stages}


def convert_mit_official(sd: Dict[str, np.ndarray], cfg,
                         prefix: str = "") -> Dict[str, Any]:
    """Official NVlabs SegFormer (mit_b0..b5.pth, config.yml SEGFORMER_B*)
    weights -> zoo/segformer stages.

    Name map over the reference's official-layout copy
    (`isegm/model/modeling/segformer/mix_transformer.py:308-...`):
      patch_embed{i}.proj/.norm
      block{i}.{j}.norm1/.attn.{q,kv,proj,sr,norm}/.norm2/
                  .mlp.{fc1,dwconv.dwconv,fc2}
      norm{i}
    Stage-1 patch conv gets the same coord-channel surgery as
    convert_mit_backbone.
    """
    def k(n):
        return f"{prefix}{n}"

    coord_ch = 3 if cfg.with_prev_mask else 2
    stages = []
    for i in range(len(cfg.embed_dims)):
        pw = sd[k(f"patch_embed{i + 1}.proj.weight")]
        pb = sd[k(f"patch_embed{i + 1}.proj.bias")]
        if i == 0 and pw.shape[1] == 3 and coord_ch > 0:
            pw = np.concatenate([pw, pw[:, :coord_ch]], axis=1)
        blocks = []
        j = 0
        while k(f"block{i + 1}.{j}.norm1.weight") in sd:
            b = k(f"block{i + 1}.{j}")
            blk = {
                "norm1": _gn(sd, f"{b}.norm1"),
                "q": _lin(sd, f"{b}.attn.q"),
                "kv": _lin(sd, f"{b}.attn.kv"),
                "proj": _lin(sd, f"{b}.attn.proj"),
                "norm2": _gn(sd, f"{b}.norm2"),
                "fc1": _lin(sd, f"{b}.mlp.fc1"),
                "dw": _conv(sd, f"{b}.mlp.dwconv.dwconv"),
                "fc2": _lin(sd, f"{b}.mlp.fc2"),
            }
            if f"{b}.attn.sr.weight" in sd:
                blk["sr"] = _conv(sd, f"{b}.attn.sr")
                blk["sr_norm"] = _gn(sd, f"{b}.attn.norm")
            blocks.append(blk)
            j += 1
        stages.append({
            "patch": {"w": np.ascontiguousarray(pw.transpose(2, 3, 1, 0)),
                      "b": pb},
            "patch_norm": _gn(sd, k(f"patch_embed{i + 1}.norm")),
            "blocks": blocks,
            "norm": _gn(sd, k(f"norm{i + 1}")),
        })
    return {"stages": stages}


def convert_plainvit_checkpoint(sd: Dict[str, np.ndarray],
                                cfg) -> Dict[str, Any]:
    """SimpleClick PlainVitModel state dict -> our plainvit params
    (is_plainvit_model.py:59-95: same ViT + coord patch-embed, SimpleFPN
    without DMA, SegFormer head without P2CL). Published SimpleClick
    checkpoints drop in through this map."""
    params: Dict[str, Any] = {
        "backbone": convert_mae_vit(sd, cfg.backbone, prefix="backbone."),
        "patch_embed_coords": conv_to_patch_embed(
            sd["patch_embed_coords.proj.weight"],
            sd["patch_embed_coords.proj.bias"]),
        "neck": {
            "down4": {"deconv1": _deconv(sd, "neck.down_4.0"),
                      "gn1": _gn(sd, "neck.down_4.1"),
                      "deconv2": _deconv(sd, "neck.down_4.3"),
                      "gn2": _gn(sd, "neck.down_4.4"),
                      "conv": _conv(sd, "neck.down_4.5"),
                      "gn3": _gn(sd, "neck.down_4.6")},
            "down8": {"deconv": _deconv(sd, "neck.down_8.0"),
                      "gn1": _gn(sd, "neck.down_8.1"),
                      "conv": _conv(sd, "neck.down_8.2"),
                      "gn2": _gn(sd, "neck.down_8.3")},
            "down16": {"conv": _conv(sd, "neck.down_16.0"),
                       "gn": _gn(sd, "neck.down_16.1")},
            "down32": {"conv1": _conv(sd, "neck.down_32.0"),
                       "gn1": _gn(sd, "neck.down_32.1"),
                       "conv2": _conv(sd, "neck.down_32.2"),
                       "gn2": _gn(sd, "neck.down_32.3")},
        },
    }
    n_scales = len(cfg.head.in_channels)
    head: Dict[str, Any] = {
        "convs": [_conv(sd, f"head.convs.{i}.conv") for i in range(n_scales)],
        "fusion": _conv(sd, "head.fusion_conv.conv"),
        "conv_seg": _conv(sd, "head.conv_seg"),
    }
    if "head.up_conv1.0.weight" in sd:
        head["up1"] = {"deconv": _deconv(sd, "head.up_conv1.0"),
                       "gn1": _gn(sd, "head.up_conv1.1"),
                       "conv": _conv(sd, "head.up_conv1.2"),
                       "gn2": _gn(sd, "head.up_conv1.3")}
    if "head.up_conv2.0.weight" in sd:
        head["up2"] = {"deconv": _deconv(sd, "head.up_conv2.0"),
                       "gn1": _gn(sd, "head.up_conv2.1"),
                       "conv": _conv(sd, "head.up_conv2.2"),
                       "gn2": _gn(sd, "head.up_conv2.3")}
    params["head"] = head
    return params


def convert_swin_backbone(sd: Dict[str, np.ndarray], cfg,
                          prefix: str = "") -> Dict[str, Any]:
    """Official Swin backbone weights -> zoo/swin params.

    Name map over the reference's mmseg-style Swin backbone
    (`isegm/model/modeling/swin_transformer.py:463-576`), which shares the
    layout of the public Microsoft releases:
      patch_embed.proj / patch_embed.norm
      layers.{i}.blocks.{j}.norm1 / .attn.qkv / .attn.proj /
                            .attn.relative_position_bias_table /
                            .norm2 / .mlp.fc1 / .mlp.fc2
      layers.{i}.downsample.norm / .reduction
      norm{i} (segmentation ckpts) or a single final norm (classification
      ckpts; missing stage norms stay identity).

    Returns the backbone portion ({"patch_embed", "patch_norm"?, "stages"})
    matching init_swin_is with cfg.patch_norm=True; coord patch embed and
    head params are trained from scratch (the reference routes coords
    through the pretrained RGB embed, swin_transformer.py:619-623 — we keep
    a separate coord embed like the ViT models). Buffers
    (relative_position_index, attn_mask) are ignored.
    """
    def k(n):
        return f"{prefix}{n}"

    out: Dict[str, Any] = {
        "patch_embed": conv_to_patch_embed(
            _t(sd[k("patch_embed.proj.weight")]),
            _t(sd[k("patch_embed.proj.bias")])),
    }
    if k("patch_embed.norm.weight") in sd:
        out["patch_norm"] = _gn(sd, k("patch_embed.norm"))

    stages = []
    for i, depth in enumerate(cfg.depths):
        base = k(f"layers.{i}")
        blocks = []
        for j in range(depth):
            b = f"{base}.blocks.{j}"
            blocks.append({
                "norm1": _gn(sd, f"{b}.norm1"),
                "qkv": _lin(sd, f"{b}.attn.qkv"),
                "proj": _lin(sd, f"{b}.attn.proj"),
                "rel_bias": _t(
                    sd[f"{b}.attn.relative_position_bias_table"]),
                "norm2": _gn(sd, f"{b}.norm2"),
                "mlp": {"fc1": _lin(sd, f"{b}.mlp.fc1"),
                        "fc2": _lin(sd, f"{b}.mlp.fc2")},
            })
        stage: Dict[str, Any] = {"blocks": blocks}
        dim = cfg.stage_dims[i]
        if k(f"norm{i}.weight") in sd:
            stage["norm"] = _gn(sd, k(f"norm{i}"))
        elif i == len(cfg.depths) - 1 and k("norm.weight") in sd:
            stage["norm"] = _gn(sd, k("norm"))
        else:
            stage["norm"] = {"scale": np.ones((dim,), np.float32),
                             "bias": np.zeros((dim,), np.float32)}
        if f"{base}.downsample.reduction.weight" in sd:
            stage["merge"] = {"norm": _gn(sd, f"{base}.downsample.norm"),
                              "lin": _lin(sd, f"{base}.downsample.reduction")}
        stages.append(stage)
    out["stages"] = stages
    return out


# ---------------------------------------------------------------------------
# CLIP (modeling/clip.py)
# ---------------------------------------------------------------------------

def _clip_block(sd, b: str) -> Dict[str, Any]:
    """A ResidualAttentionBlock: torch nn.MultiheadAttention's packed
    in_proj maps onto the fused qkv."""
    return {"ln1": _gn(sd, f"{b}.ln_1"),
            "qkv": {"w": sd[f"{b}.attn.in_proj_weight"].T,
                    "b": sd[f"{b}.attn.in_proj_bias"]},
            "proj": _lin(sd, f"{b}.attn.out_proj"),
            "ln2": _gn(sd, f"{b}.ln_2"),
            "mlp": {"fc1": _lin(sd, f"{b}.mlp.c_fc"),
                    "fc2": _lin(sd, f"{b}.mlp.c_proj")}}


def _clip_blocks(sd, pre: str) -> list:
    blocks = []
    while f"{pre}transformer.resblocks.{len(blocks)}.ln_1.weight" in sd:
        blocks.append(_clip_block(
            sd, f"{pre}transformer.resblocks.{len(blocks)}"))
    return blocks


def convert_clip_resnet(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """CLIP ModifiedResNet state dict (`modeling/clip.py:147-223`; keys
    optionally prefixed `visual.`) -> the `ModifiedResNet` tree. `cfg` is a
    ClipVisualConfig."""
    pre = "visual." if "visual.conv1.weight" in sd else ""

    def block(prefix):
        p = {"c1": _conv_bn(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
             "c2": _conv_bn(sd, f"{prefix}.conv2", f"{prefix}.bn2"),
             "c3": _conv_bn(sd, f"{prefix}.conv3", f"{prefix}.bn3")}
        if f"{prefix}.downsample.0.weight" in sd:
            p["down"] = _conv_bn(sd, f"{prefix}.downsample.0",
                                 f"{prefix}.downsample.1")
        return p

    def layer(name, blocks):
        return [block(f"{pre}{name}.{j}") for j in range(blocks)]

    ap = f"{pre}attnpool"
    return {
        "stem1": _conv_bn(sd, f"{pre}conv1", f"{pre}bn1"),
        "stem2": _conv_bn(sd, f"{pre}conv2", f"{pre}bn2"),
        "stem3": _conv_bn(sd, f"{pre}conv3", f"{pre}bn3"),
        "layer1": layer("layer1", cfg.layers[0]),
        "layer2": layer("layer2", cfg.layers[1]),
        "layer3": layer("layer3", cfg.layers[2]),
        "layer4": layer("layer4", cfg.layers[3]),
        "attnpool": {
            "pos": sd[f"{ap}.positional_embedding"],
            "q": _lin(sd, f"{ap}.q_proj"),
            "k": _lin(sd, f"{ap}.k_proj"),
            "v": _lin(sd, f"{ap}.v_proj"),
            "c": _lin(sd, f"{ap}.c_proj"),
            "connect": _conv_bn(sd, f"{ap}.connect.0", f"{ap}.connect.1"),
        },
    }


def convert_clip_vit(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """CLIP VisionTransformer state dict (`modeling/clip.py:286-332`; keys
    optionally prefixed `visual.`) -> the `ClipViT` tree."""
    pre = "visual." if "visual.conv1.weight" in sd else ""
    return {
        "conv1": _conv(sd, f"{pre}conv1"),
        "class_embedding": sd[f"{pre}class_embedding"],
        "pos_embedding": sd[f"{pre}positional_embedding"],
        "ln_pre": _gn(sd, f"{pre}ln_pre"),
        "blocks": _clip_blocks(sd, pre),
        "ln_post": _gn(sd, f"{pre}ln_post"),
        "proj": sd[f"{pre}proj"],
    }


def convert_clip_text(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """CLIP text-encoder state dict (`modeling/clip.py:353-456`) -> the
    `ClipText` tree; a state dict without `logit_scale` gets CLIP's
    initial log(1 / 0.07)."""
    return {
        "token_embedding": sd["token_embedding.weight"],
        "pos_embedding": sd["positional_embedding"],
        "blocks": _clip_blocks(sd, ""),
        "ln_final": _gn(sd, "ln_final"),
        "text_projection": sd["text_projection"],
        "logit_scale": sd.get("logit_scale", np.float32(np.log(1 / 0.07))),
    }


def load_clip(tree: Dict[str, Any], cfg) -> torch.nn.Module:
    """A converted CLIP tree -> its module on the CPU (`ClipText`,
    `ModifiedResNet` or `ClipViT`, by the type of `cfg`), loaded strictly:
    missing, extra or mis-shaped leaves raise."""
    from ..models.zoo import clip_text as C
    cls = {C.ClipTextConfig: C.ClipText, C.ClipVisualConfig:
           C.ModifiedResNet, C.ClipViTConfig: C.ClipViT}[type(cfg)]
    module = cls(cfg)
    module.load_state_dict(params_from_numpy(flatten_tree(tree)))
    return module
