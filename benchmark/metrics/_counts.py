"""Operations, bytes and roofline bounds of the work at a configuration's
shapes, and the model FLOPs of one forward.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 off them, 3.35 TB/s
of HBM. A bound is the larger of operations over the peak rate and bytes
over the HBM rate, each input byte counted once and each output byte once.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM = 3.35e12
BF16 = 2


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16
          ) -> Tuple[float, str]:
    """(seconds, which bound: "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / HBM
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention(bh: int, n: int, d: int) -> Tuple[float, float]:
    """Attention forward over (BH, N, Dh) bf16: QK^T and PV (4 BH N^2 Dh
    operations); q, k, v read and o written once."""
    return 4.0 * bh * n * n * d, 4.0 * bh * n * d * BF16


def ln_mlp(m: int, d: int, h: int) -> Tuple[float, float]:
    """LN + fc1 + GELU + fc2 + residual over (M, D) bf16 rows, hidden H:
    the two products (4 M D H operations); x read, out written, both
    weight matrices, biases and LayerNorm parameters read once."""
    return 4.0 * m * d * h, (2.0 * m * d + 2.0 * d * h + h + 3.0 * d) * BF16


def minplus(rows: int, w: int) -> Tuple[float, float]:
    """The EDT's row pass over (R, W) f32: R W f32 read and written (its
    ~20 integer operations per element stay under the byte time)."""
    return 0.0, 8.0 * rows * w


def vit_shapes(bb: dict) -> Dict[str, int]:
    ph, pw = bb["patch_size"]
    gh, gw = bb["img_size"][0] // ph, bb["img_size"][1] // pw
    wh, ww = bb["window_pixels"] // ph, bb["window_pixels"] // pw
    nwin = (gh // wh) * (gw // ww)
    if gh % max(wh, 1) or gw % max(ww, 1) or gh < wh:
        nwin = 1
    depth = bb["depth"]
    group = 6 if depth == 12 else depth // 4
    return {"tokens": gh * gw, "grid_h": gh, "grid_w": gw, "windows": nwin,
            "global_blocks": depth // group, "depth": depth,
            "dim": bb["embed_dim"], "heads": bb["num_heads"],
            "hidden": int(bb["embed_dim"] * bb.get("mlp_ratio", 4.0))}


def attention_calls(cfg: dict, batch: int) -> List[Tuple[int, int, int]]:
    """(BH, N, Dh) of every backbone attention call of one forward at model
    batch `batch`."""
    s = vit_shapes(cfg["backbone"])
    hd = s["dim"] // s["heads"]
    out = []
    for i in range(1, s["depth"] + 1):
        group = s["depth"] // s["global_blocks"]
        if i % group or s["windows"] == 1:
            out.append((batch * s["windows"] * s["heads"],
                        s["tokens"] // s["windows"], hd))
        else:
            out.append((batch * s["heads"], s["tokens"], hd))
    return out


def ln_mlp_calls(cfg: dict, batch: int) -> List[Tuple[int, int, int]]:
    """(M, D, H) of every backbone LN+MLP call of one forward."""
    s = vit_shapes(cfg["backbone"])
    return [(batch * s["tokens"], s["dim"], s["hidden"])] * s["depth"]


def _mm(m: float, k: float, n: float) -> float:
    return 2.0 * m * k * n


def model_flops(cfg: dict, batch: int) -> float:
    """Product and resize FLOPs of one VPU forward at model batch `batch`
    (elementwise work, norms and activations not counted): the two patch
    embeddings, the ViT blocks, the prompt FFN, the two-way transformer,
    the neck's four branches, the head with its P2CL branch and the final
    resizes of both outputs to the crop."""
    bb, nk = cfg["backbone"], cfg["neck"]
    s = vit_shapes(bb)
    d, n, hid = s["dim"], s["tokens"], s["hidden"]
    ph, pw = bb["patch_size"]
    crop_h, crop_w = bb["img_size"]
    f = 2 * _mm(n, ph * pw * 3, d)                       # image + coords
    for bh, nt, hd in attention_calls(cfg, 1):
        f += 4.0 * bh * nt * nt * hd
    f += s["depth"] * (_mm(n, d, 3 * d) + _mm(n, d, d) + 2 * _mm(n, d, hid))
    # prompts: 2 * num_max_points queries
    L = 2 * cfg["num_max_points"]
    f += _mm(L, crop_h * 2 + 3, 2 * nk["hide_dim"]) + _mm(
        L, 2 * nk["hide_dim"], d)
    tw = nk["two_way"]
    di = d // tw["attention_downsample_rate"]

    def attn(nq, nkv, inner):
        return (_mm(nq, d, inner) + 2 * _mm(nkv, d, inner)
                + 4.0 * nq * nkv * inner + _mm(nq, inner, d))
    for _ in range(tw["depth"]):
        f += attn(L, L, d) + attn(L, n, di) + 2 * _mm(L, d, tw["mlp_dim"]) \
            + attn(n, L, di)
    f += attn(L, n, di)
    # neck branches (NHWC maps at strides 4, 8, 16, 32)
    od = nk["out_dims"]
    c4 = max(od[0] * 2, d // 2)
    c8 = max(od[1], d // 2)
    c32 = max(od[3], d * 2)
    f += _mm(n, d, 4 * c4) + _mm(4 * n, c4, 4 * (c4 // 2)) \
        + _mm(16 * n, c4 // 2, od[0])
    f += _mm(n, d, 4 * c8) + _mm(4 * n, c8, od[1])
    f += _mm(n, d, od[2])
    f += _mm(n / 4, 4 * d, c32) + _mm(n / 4, c32, od[3])
    # head: 1x1 convs per scale, resizes to stride 4, fusion, seg conv
    hd_ = cfg["head"]
    ch = hd_["channels"]
    h4, w4 = s["grid_h"] * 4, s["grid_w"] * 4
    for scale, c in zip((1, 2, 4, 8), od):
        hs, ws = h4 // scale, w4 // scale
        f += _mm(hs * ws, c, ch)
        if scale > 1:
            f += 2.0 * (h4 * hs * ws * ch + h4 * w4 * ws * ch)
    f += _mm(h4 * w4, 4 * ch, ch) + _mm(h4 * w4, ch, 1)
    # P2CL: query FFN, cosine similarities, then both outputs resized
    f += _mm(L, d, 2 * d) + _mm(L, 2 * d, ch) + _mm(h4 * w4, ch, L)
    for c in (1, L):
        f += 2.0 * (crop_h * h4 * w4 * c + crop_h * crop_w * w4 * c)
    return batch * f
