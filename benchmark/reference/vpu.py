"""Plain forward of the VPU click model (ViT backbone, disk maps, PPuE
click vectors, DMA neck with the two-way transformer, SegFormer head),
written from the published architecture (PVPUFormer, arXiv 2306.06656; the
ViT-H backbone of MAE, arXiv 2111.06377) over a dict of named tensors.

Plain torch only: every product in float32 with float32 accumulation,
dense attention, LayerNorm and GroupNorm with f32 statistics, every conv
as a matmul. It imports nothing of the program under test; the parameter
names are those the benchmark draws (`benchmark/weights.py`), and every
derived constant (ImageNet statistics, the 2-D sine encoding, resize
matrices) is computed here again.

The configuration states the dtype the model is served in. Its numerics
are part of the model, as the PVPUFormer recipe runs it: in bfloat16 every
activation is a bf16 value, so this forward rounds each op's result to
bf16 where an op of a bf16 model yields it (`Num.r`: a product, a sum,
a norm, an activation), and bf16 GELU is the tanh one. What stays is the
precision of the products and the order of the sums, the part a change
of the served precision moves. In float32 nothing is rounded.

Only the "instances" logits are computed: the P2CL branch feeds the
training loss alone and does not reach the click mask.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Params = Dict[str, torch.Tensor]


class Num:
    """The served dtype's arithmetic on f32-held values: `r(x)` rounds x to
    that dtype; `mm` and `einsum` are PyTorch's products in that dtype (f32
    accumulation), rounded. Identity and f32 products in float32.

    `reverse` sums the products of the backbone's attention and MLP, which
    run in f32 up to one rounding (`kmm`), over their axis in reverse: the
    same arithmetic in another order of sums."""

    def __init__(self, dtype: str, reverse: bool = False):
        self.dtype = getattr(torch, dtype)
        self.exact = self.dtype == torch.float32
        self.reverse = reverse

    def kmm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (..., K, N) in f32."""
        if self.reverse:
            return x.flip(-1) @ w.flip(-2)
        return x @ w

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.exact else x.to(self.dtype).float()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.exact:
            return x @ w
        return (x.to(self.dtype) @ w.to(self.dtype)).float()

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        if self.exact:
            return torch.einsum(eq, a, b)
        return torch.einsum(eq, a.to(self.dtype), b.to(self.dtype)).float()

    def conv2x2s2(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A 2 x 2 conv of stride 2, NHWC input, HWIO weight: a patch
        product in float32, PyTorch's conv in a narrower dtype."""
        if self.exact:
            b, h, wd, _ = x.shape
            y = patches(x, 2, 2) @ w.reshape(-1, w.shape[-1])
            return y.reshape(b, h // 2, wd // 2, -1)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     w.to(self.dtype).permute(3, 2, 0, 1), stride=2)
        return y.permute(0, 2, 3, 1).float()

    def gelu(self, x: torch.Tensor) -> torch.Tensor:
        return self.r(F.gelu(x, approximate="none" if self.exact else "tanh"))


def linear(P: Params, nx: Num, name: str, x: torch.Tensor) -> torch.Tensor:
    y = nx.mm(x, P[name + ".w"])
    b = P.get(name + ".b")
    return y if b is None else nx.r(y + b)


def layer_norm(P: Params, nx: Num, name: str, x: torch.Tensor, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return nx.r((x - mean) * torch.rsqrt(var + eps) * P[name + ".scale"]
                + P[name + ".bias"])


def group_norm1(P: Params, nx: Num, name: str, x: torch.Tensor,
                eps: float = 1e-5):
    """GroupNorm(1, C) over NHWC: statistics over (H, W, C)."""
    dims = tuple(range(1, x.ndim))
    mean = x.mean(dims, keepdim=True)
    var = (x - mean).square().mean(dims, keepdim=True)
    return nx.r((x - mean) * torch.rsqrt(var + eps) * P[name + ".scale"]
                + P[name + ".bias"])


def conv1x1(P: Params, nx: Num, name: str, x: torch.Tensor) -> torch.Tensor:
    w = P[name + ".w"]
    return nx.r(nx.mm(x, w.reshape(w.shape[-2], w.shape[-1])) + P[name + ".b"])


def deconv2x2(P: Params, nx: Num, name: str, x: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=2, s=2), weight (in, 2, 2, out)."""
    w = P[name + ".w"]
    b, h, wd, cin = x.shape
    y = nx.mm(x, w.reshape(cin, -1))
    out = w.shape[-1]
    y = y.reshape(b, h, wd, 2, 2, out).permute(0, 1, 3, 2, 4, 5)
    return nx.r(y.reshape(b, 2 * h, 2 * wd, out) + P[name + ".b"])


def patches(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/ph * W/pw, ph*pw*C), patches flattened
    (ph, pw, C)."""
    b, h, w, c = x.shape
    x = x[:, :h // ph * ph, :w // pw * pw]
    gh, gw = h // ph, w // pw
    x = x.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, ph * pw * c)


def patch_embed(P: Params, nx: Num, name: str, x: torch.Tensor, ph: int,
                pw: int):
    w = P[name + ".w"]
    y = nx.mm(patches(x, ph, pw), w.reshape(-1, w.shape[-1]))
    return nx.r(y + P[name + ".b"])


def block_attention(nx: Num, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor):
    """The backbone's attention, (B, N, H, Dh) -> (B, N, H, Dh): scores and
    softmax in f32, the probabilities rounded, P.V in f32, rounded."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B, H, N, Dh)
    p = nx.r(torch.softmax(nx.kmm(q, k.transpose(-1, -2)) * scale, -1))
    return nx.r(nx.kmm(p, v)).transpose(1, 2)


def neck_attention(nx: Num, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor):
    """The two-way transformer's dense attention, (B, N, H, Dh): the
    scores rounded, scaled by the scale as a value of the served dtype and
    rounded, an f32 softmax rounded, P.V rounded."""
    scale = nx.r(torch.tensor(1.0 / math.sqrt(q.shape[-1])))
    s = nx.r(nx.einsum("bqhd,bkhd->bhqk", q, k) * scale)
    p = nx.r(torch.softmax(s, -1))
    return nx.einsum("bhqk,bkhd->bqhd", p, v)


# --------------------------------------------------------------- resizes

def axis_matrix(src: int, dst: int, align_corners: bool,
                device) -> torch.Tensor:
    """(dst, src) bilinear interpolation matrix, positions in f64."""
    i = np.arange(dst, dtype=np.float64)
    m = np.zeros((dst, src), np.float64)
    if src == 1 or dst == 1:
        m[:, 0] = 1.0
    else:
        x = i * (src - 1) / (dst - 1) if align_corners else \
            (i + 0.5) * src / dst - 0.5
        x = np.clip(x, 0.0, src - 1)
        x0 = np.floor(x).astype(np.int64)
        x1 = np.minimum(x0 + 1, src - 1)
        w1 = x - x0
        np.add.at(m, (np.arange(dst), x0), 1.0 - w1)
        np.add.at(m, (np.arange(dst), x1), w1)
    return torch.from_numpy(m.astype(np.float32)).to(device)


def resize(nx: Num, x: torch.Tensor, out_h: int, out_w: int,
           align_corners: bool):
    """NHWC bilinear resize (torch `F.interpolate` semantics) as two
    interpolation matrices, which a bf16 model holds in bf16, each pass
    rounded."""
    b, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    mh = nx.r(axis_matrix(h, out_h, align_corners, x.device))
    mw = nx.r(axis_matrix(w, out_w, align_corners, x.device))
    y = nx.einsum("Oh,bhwc->bOwc", mh, x)
    return nx.einsum("Pw,bhwc->bhPc", mw, y)


# ------------------------------------------------------- prompt encodings

def disk_maps(points: torch.Tensor, rows: int, cols: int,
              radius: float) -> torch.Tensor:
    """(B, 2N, 3) clicks (y, x, order), first N positive -> (B, H, W, 2)
    disks of `radius`; a slot with max(y, x) < 0 is empty."""
    b, twon, _ = points.shape
    n = twon // 2
    pts = points.reshape(b * 2, n, 3)
    yy = torch.arange(rows, dtype=torch.float32, device=points.device)
    xx = torch.arange(cols, dtype=torch.float32, device=points.device)
    dy = yy[:, None] - pts[..., 0, None, None]
    dx = xx[None, :] - pts[..., 1, None, None]
    empty = torch.maximum(pts[..., 0], pts[..., 1]) < 0
    d2 = torch.where(empty[..., None, None], 1e6, dy * dy + dx * dx)
    on = (d2.amin(1) <= radius * radius).float()
    return on.reshape(b, 2, rows, cols).permute(0, 2, 3, 1)


def click_vectors(points: torch.Tensor, crop: Tuple[int, int],
                  num_max_points: int, sigma: float = 3.0) -> torch.Tensor:
    """PPuE click vectors: per click a Gaussian profile of length W centred
    at the click's ROW, one of length H at its COLUMN (radius 3 sigma, the
    peak raised by 1; zero when the click's square lies outside), and the
    type label [pos, neg, 0]; an empty slot is [0 ... 0, 0, 0, 1]. Each
    half is padded to `num_max_points` with empty slots."""
    b, twon, _ = points.shape
    n = twon // 2
    out_h, out_w = crop
    dim = out_w + out_h + 3
    radius = int(sigma * 3)
    a = torch.trunc(points[..., 0]).to(torch.int32)
    c = torch.trunc(points[..., 1]).to(torch.int32)

    def in_img(p0, p1):
        return (p0 >= 0) & (p0 <= out_w) & (p1 >= 0) & (p1 <= out_h)

    valid = (in_img(a - radius, c - radius)
             | in_img(a + radius + 1, c + radius + 1)).float()[..., None]

    def profile(length, centre):
        d = (torch.arange(length, dtype=torch.float32, device=points.device)
             - centre.float()[..., None])
        g = torch.exp(-(d * d) / (2.0 * sigma * sigma))
        return torch.where(d.abs() <= radius, g, 0.0) + (d == 0).float()

    is_pos = (torch.arange(twon, device=points.device) < n).float()
    label = torch.stack([is_pos, 1.0 - is_pos, torch.zeros_like(is_pos)],
                        -1).expand(b, twon, 3)
    vec = torch.cat([profile(out_w, a) * valid, profile(out_h, c) * valid,
                     label], -1)
    empty = (torch.arange(dim, device=points.device) == dim - 1).float()
    vec = torch.where((points[..., 2] == -1)[..., None], empty, vec)
    if num_max_points == n:
        return vec
    pad = empty.expand(b, num_max_points - n, dim)
    return torch.cat([vec[:, :n], pad, vec[:, n:], pad], 1)


def sine_encoding(d: int, h: int, w: int) -> torch.Tensor:
    """Interleaved 2-D sin / cos encoding, (h*w, d): the first d/2 channels
    encode the column, the rest the row."""
    pe = np.zeros((d, h, w), np.float64)
    dm = d // 2
    div = np.exp(np.arange(0.0, dm, 2) * -(math.log(10000.0) / dm))
    pw = np.arange(0.0, w)[:, None] * div[None, :]
    ph = np.arange(0.0, h)[:, None] * div[None, :]
    pe[0:dm:2] = np.sin(pw).T[:, None, :]
    pe[1:dm:2] = np.cos(pw).T[:, None, :]
    pe[dm::2] = np.sin(ph).T[:, :, None]
    pe[dm + 1::2] = np.cos(ph).T[:, :, None]
    return torch.from_numpy(pe.reshape(d, h * w).T.astype(np.float32))


# --------------------------------------------------------------- backbone

def _windows(cfg: dict) -> Tuple[int, int, int, int]:
    """(grid h, grid w, windows down, windows across)."""
    ph, pw = cfg["patch_size"]
    gh, gw = cfg["img_size"][0] // ph, cfg["img_size"][1] // pw
    wh, ww = cfg["window_pixels"] // ph, cfg["window_pixels"] // pw
    if gh % max(wh, 1) or gw % max(ww, 1) or gh < wh:
        return gh, gw, 1, 1
    return gh, gw, gh // wh, gw // ww


def to_windows(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    gh, gw, nh, nw = _windows(cfg)
    b, n, c = x.shape
    x = x.reshape(b, nh, gh // nh, nw, gw // nw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, n // (nh * nw), c)


def from_windows(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    gh, gw, nh, nw = _windows(cfg)
    bw, n, c = x.shape
    x = x.reshape(bw // (nh * nw), nh, nw, gh // nh, gw // nw, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(bw // (nh * nw), nh * nw * n, c)


def vit_block(P: Params, nx: Num, name: str, x: torch.Tensor, heads: int,
              eps: float) -> torch.Tensor:
    """Pre-norm block. The MLP half rounds where one fused op would: the
    LayerNorm's output, the GELU's, and the output after fc2's bias and
    the residual, once."""
    b, n, d = x.shape
    qkv = linear(P, nx, name + ".attn.qkv",
                 layer_norm(P, nx, name + ".norm1", x, eps))
    qkv = qkv.reshape(b, n, 3, heads, d // heads)
    o = block_attention(nx, qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    x = nx.r(x + linear(P, nx, name + ".attn.proj", o.reshape(b, n, d)))
    y = layer_norm(P, nx, name + ".norm2", x, eps)
    h = nx.gelu(nx.kmm(y, P[name + ".mlp.fc1.w"]) + P[name + ".mlp.fc1.b"])
    return nx.r(nx.kmm(h, P[name + ".mlp.fc2.w"]) + P[name + ".mlp.fc2.b"]
                + x)


def backbone(P: Params, nx: Num, cfg: dict, rgb: torch.Tensor,
             coords: torch.Tensor) -> torch.Tensor:
    """Patch embeddings of the image and of the coord maps, summed with the
    positional embedding; blocks in windows except every group's last,
    which is global (a group is 6 blocks at depth 12, depth / 4 else)."""
    ph, pw = cfg["patch_size"]
    x = nx.r(patch_embed(P, nx, "backbone.patch_embed", rgb, ph, pw)
             + patch_embed(P, nx, "patch_embed_coords", coords, ph, pw))
    x = nx.r(x + P["backbone.pos_embed"][:, 1:])
    depth = cfg["depth"]
    group = 6 if depth == 12 else depth // 4
    _, _, nh, nw = _windows(cfg)
    windowed = False
    for i in range(1, depth + 1):
        if nh * nw > 1 and i % group and not windowed:
            x, windowed = to_windows(x, cfg), True
        elif not i % group and windowed:
            x, windowed = from_windows(x, cfg), False
        x = vit_block(P, nx, f"backbone.blocks.{i - 1}", x, cfg["num_heads"],
                      cfg.get("ln_eps", 1e-6))
    return from_windows(x, cfg) if windowed else x


# ------------------------------------------------------------------- neck

def down_attention(P: Params, nx: Num, name: str, q, k, v, heads: int):
    q, k, v = (linear(P, nx, f"{name}.{s}", t) for s, t in
               (("q", q), ("k", k), ("v", v)))
    b, nq, c = q.shape
    nk = k.shape[1]
    o = neck_attention(nx, q.reshape(b, nq, heads, c // heads),
                       k.reshape(b, nk, heads, c // heads),
                       v.reshape(b, nk, heads, c // heads))
    return linear(P, nx, name + ".out", o.reshape(b, nq, c))


def two_way(P: Params, nx: Num, tw: dict, queries, keys, key_pe):
    """Per block: query self-attention (the first without PE or residual),
    token -> image, query MLP (ReLU), image -> token, each then LayerNorm;
    a final token -> image. Returns the keys and queries after blocks 1 and
    2 and after the final attention."""
    heads, eps = tw["num_heads"], tw.get("ln_eps", 1e-5)
    r = nx.r
    query_pe = queries
    out = []
    for i in range(tw["depth"]):
        n = f"neck.att.layers.{i}"
        if i == 0:
            queries = down_attention(P, nx, n + ".self_attn", queries,
                                     queries, queries, heads)
        else:
            q = r(queries + query_pe)
            queries = r(queries + down_attention(P, nx, n + ".self_attn", q,
                                                 q, queries, heads))
        queries = layer_norm(P, nx, n + ".norm1", queries, eps)
        q, k = r(queries + query_pe), r(keys + key_pe)
        queries = r(queries + down_attention(P, nx, n + ".cross_t2i", q, k,
                                             keys, heads))
        queries = layer_norm(P, nx, n + ".norm2", queries, eps)
        h = torch.relu(linear(P, nx, n + ".mlp.fc1", queries))
        queries = layer_norm(P, nx, n + ".norm3",
                             r(queries + linear(P, nx, n + ".mlp.fc2", h)),
                             eps)
        q, k = r(queries + query_pe), r(keys + key_pe)
        keys = layer_norm(P, nx, n + ".norm4", r(keys + down_attention(
            P, nx, n + ".cross_i2t", k, q, queries, heads)), eps)
        if i != tw["depth"] - 1:
            out.append((queries, keys))
    o = down_attention(P, nx, "neck.att.final_t2i", r(queries + query_pe),
                       r(keys + key_pe), keys, heads)
    queries = layer_norm(P, nx, "neck.att.norm_final", r(queries + o), eps)
    out.append((queries, keys))
    return out


def neck(P: Params, nx: Num, cfg: dict, x: torch.Tensor,
         prompts: torch.Tensor) -> List[torch.Tensor]:
    """Backbone tokens (B, N, D) and PPuE vectors -> maps at strides 4, 8,
    16, 32 (NHWC); the two-way transformer's outputs gate the tokens of the
    three coarser branches."""
    bb = cfg["backbone"]
    r = nx.r
    ph, pw = bb["patch_size"]
    gh, gw = bb["img_size"][0] // ph, bb["img_size"][1] // pw
    b, n, c = x.shape
    q = linear(P, nx, "neck.ffn.fc2",
               torch.relu(linear(P, nx, "neck.ffn.fc1", r(prompts))))
    pe = r(sine_encoding(c, gh, gw).to(x.device)[None])
    (q2, k2), (q3, k3), (q4, k4) = two_way(P, nx, cfg["neck"]["two_way"], q,
                                           x, pe)

    def gate(qi, ki):
        chan = r(torch.sigmoid(qi.amax(1)))[:, None, :]
        tok = r(torch.sigmoid(ki.amax(2)))[:, :, None]
        return r(r(x + r(x * chan)) + r(x * tok)).reshape(b, gh, gw, c)

    m = x.reshape(b, gh, gw, c)
    s4 = nx.gelu(group_norm1(P, nx, "neck.down4.gn1",
                             deconv2x2(P, nx, "neck.down4.deconv1", m)))
    s4 = group_norm1(P, nx, "neck.down4.gn2",
                     deconv2x2(P, nx, "neck.down4.deconv2", s4))
    s4 = nx.gelu(group_norm1(P, nx, "neck.down4.gn3",
                             conv1x1(P, nx, "neck.down4.conv", s4)))
    s8 = group_norm1(P, nx, "neck.down8.gn1",
                     deconv2x2(P, nx, "neck.down8.deconv", gate(q2, k2)))
    s8 = nx.gelu(group_norm1(P, nx, "neck.down8.gn2",
                             conv1x1(P, nx, "neck.down8.conv", s8)))
    s16 = nx.gelu(group_norm1(P, nx, "neck.down16.gn",
                              conv1x1(P, nx, "neck.down16.conv",
                                      gate(q3, k3))))
    s32 = r(nx.conv2x2s2(gate(q4, k4), P["neck.down32.conv1.w"])
            + P["neck.down32.conv1.b"])
    s32 = group_norm1(P, nx, "neck.down32.gn1", s32)
    s32 = nx.gelu(group_norm1(P, nx, "neck.down32.gn2",
                              conv1x1(P, nx, "neck.down32.conv2", s32)))
    return [s4, s8, s16, s32]


def head(P: Params, nx: Num, feats: List[torch.Tensor]) -> torch.Tensor:
    """All-MLP fusion at stride 4 -> one logit channel."""
    th, tw = feats[0].shape[1], feats[0].shape[2]
    outs = [resize(nx, torch.relu(conv1x1(P, nx, f"head.convs.{i}", f)), th,
                   tw, align_corners=False) for i, f in enumerate(feats)]
    out = torch.relu(conv1x1(P, nx, "head.fusion", torch.cat(outs, -1)))
    return conv1x1(P, nx, "head.conv_seg", out)


def forward(P: Params, cfg: dict, image: torch.Tensor,
            points: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """image (B, H, W, 4): RGB in [0, 1] and the previous mask; points
    (B, 2N, 3) click slots in crop coordinates -> logits (B, H, W, 1), in
    the configuration's dtype (`Num`), held as f32."""
    nx = Num(cfg["dtype"], reverse)
    h, w = image.shape[1], image.shape[2]
    image = nx.r(image)
    mean = nx.r(torch.tensor(IMAGENET_MEAN, device=image.device))
    std = nx.r(torch.tensor(IMAGENET_STD, device=image.device))
    rgb = nx.r(nx.r(image[..., :3] - mean) * (1.0 / std))
    coords = torch.cat([image[..., 3:4],
                        disk_maps(points, h, w, cfg["norm_radius"])], -1)
    tokens = backbone(P, nx, cfg["backbone"], rgb, coords)
    prompts = click_vectors(points, tuple(cfg["backbone"]["img_size"]),
                            cfg["num_max_points"])
    seg = head(P, nx, neck(P, nx, cfg, tokens, prompts))
    return resize(nx, seg, h, w, align_corners=True)
