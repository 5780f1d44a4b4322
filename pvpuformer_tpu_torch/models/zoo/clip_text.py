"""CLIP: the text encoder, the two visual towers and the tokenizers
(pvpuformer_tpu/models/zoo/clip_text.py).

  * text side: token embedding, causal transformer (QuickGELU, LN eps
    1e-5), ln_final, text projection, `encode_text` pooled at the EOT token
    (the first maximum of the token ids);
  * the ModifiedResNet visual tower: 3-conv stem + avgpool, anti-aliased
    bottlenecks (avgpool before the strided projections), and the
    multi-scale return (x2, x3, attention-pooled x4), the pool's positional
    embedding resized by two constant bicubic matrices (align_corners=False);
  * the VisionTransformer visual tower: patch conv, class token,
    ln_pre / ln_post, projected grid tokens (the class token dropped);
  * `BPETokenizer` (CLIP's byte-level BPE over a merges file) and
    `byte_tokenizer` (BOS + utf-8 bytes + EOS), pure Python.

The towers are plain PyTorch (JAX computes them with XLA, outside any
Pallas kernel). Their attention is not `nn.sdpa`: it keeps f32 logits
(no rounding to the activation dtype) and masks them with -1e9; its
MLPs are QuickGELU `nn.mlp`s, not the gelu-tanh LN+MLP kernel. Module
attribute names are the JAX tree's keys, so a JAX checkpoint loads
strictly.
"""
from __future__ import annotations

import dataclasses
import gzip
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn as tnn

from ... import nn
from ...ops.resize import _bicubic_axis_matrix
from .common import conv_bn, frozen_bn


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512                 # output projection dim

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class ClipBlock(tnn.Module):
    """A residual attention block: ln1, packed qkv, proj, ln2, mlp."""

    def __init__(self, d: int, g: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = nn.Norm(d)
        self.qkv = nn.Linear(d, 3 * d, init="xavier", g=g)
        self.proj = nn.Linear(d, d, init="xavier", g=g)
        self.ln2 = nn.Norm(d)
        self.mlp = nn.Mlp(d, 4 * d, init="xavier", g=g)


class ClipText(tnn.Module):
    """The JAX `init_clip_text` tree; `generator=None` leaves the weights
    zero, for loading."""

    def __init__(self, cfg: ClipTextConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.token_embedding = nn.param(nn.normal_init(
            (cfg.vocab_size, cfg.width), g, std=0.02))
        self.pos_embedding = nn.param(nn.normal_init(
            (cfg.context_length, cfg.width), g, std=0.01))
        self.blocks = tnn.ModuleList(ClipBlock(cfg.width, g)
                                     for _ in range(cfg.layers))
        self.ln_final = nn.Norm(cfg.width)
        self.text_projection = nn.param(nn.normal_init(
            (cfg.width, cfg.embed_dim), g, std=cfg.width ** -0.5))
        self.logit_scale = nn.param(torch.tensor(math.log(1 / 0.07),
                                                 dtype=torch.float32))


def init_clip_text(cfg: ClipTextConfig, generator: torch.Generator,
                   device=None) -> ClipText:
    """Seeded random weights, built on the CPU and moved to `device` (None:
    the card)."""
    return ClipText(cfg, generator).to(nn.resolve_device(device))


def _attn(p: ClipBlock, x: torch.Tensor, heads: int,
          causal: bool = True) -> torch.Tensor:
    """`_causal_attn`: qkv laid out (b, n, 3, heads, dh); f32 logits
    (bf16 operands give exact f32 products), masked with -1e9 above the
    diagonal when `causal`; f32 softmax rounded to x's dtype; the PV
    product accumulated in f32 and rounded once."""
    b, n, d = x.shape
    qkv = nn.linear(p.qkv, x).reshape(b, n, 3, heads, d // heads)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = (d // heads) ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        logits = torch.where(mask, logits, -1e9)
    probs = torch.softmax(logits, -1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return nn.linear(p.proj, out.reshape(b, n, d))


def _blocks(blocks, x: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    for p in blocks:
        x = x + _attn(p, nn.layer_norm(p.ln1, x, 1e-5), heads, causal)
        x = x + nn.mlp(p.mlp, nn.layer_norm(p.ln2, x, 1e-5),
                       act=nn.quick_gelu)
    return x


def encode_text(p: ClipText, cfg: ClipTextConfig,
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, context_length) int ids (0-padded after EOT) -> (B,
    embed_dim) embeddings pooled at the argmax (EOT) token. The activations
    take the parameters' dtype."""
    b, n = tokens.shape
    # index_select and gather: their backwards are index_add_ and
    # scatter_add_, which need no host sync
    x = p.token_embedding.index_select(0, tokens.reshape(-1).long())
    x = x.reshape(b, n, -1) + p.pos_embedding
    x = _blocks(p.blocks, x, cfg.heads, causal=True)
    x = nn.layer_norm(p.ln_final, x, 1e-5)
    eot = tokens.argmax(-1)                          # the first maximum
    pooled = x.gather(1, eot[:, None, None].expand(b, 1, x.shape[-1]))[:, 0]
    return pooled @ p.text_projection.to(pooled.dtype)


# ---------------------------------------------------------------------------
# the ModifiedResNet visual tower (clip.py:10-223)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClipVisualConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)   # RN50
    width: int = 64
    heads: int = 32                     # embed_dim // 64 for RN50
    output_dim: int = 1024
    input_resolution: int = 224

    @property
    def embed_dim(self) -> int:
        return self.width * 32

    @property
    def spacial_dim(self) -> int:
        return self.input_resolution // 32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class ClipBottleneck(tnn.Module):
    def __init__(self, cin: int, planes: int, stride: int, g=None):
        super().__init__()
        self.c1 = conv_bn(1, 1, cin, planes, g)
        self.c2 = conv_bn(3, 3, planes, planes, g)
        self.c3 = conv_bn(1, 1, planes, planes * 4, g)
        if stride > 1 or cin != planes * 4:
            self.down = conv_bn(1, 1, cin, planes * 4, g)


class ModifiedResNet(tnn.Module):
    """The JAX `init_modified_resnet` tree."""

    def __init__(self, cfg: ClipVisualConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, w = generator, cfg.width
        self.stem1 = conv_bn(3, 3, 3, w // 2, g)
        self.stem2 = conv_bn(3, 3, w // 2, w // 2, g)
        self.stem3 = conv_bn(3, 3, w // 2, w, g)

        def layer(cin, planes, blocks, stride):
            return tnn.ModuleList(
                [ClipBottleneck(cin, planes, stride, g)]
                + [ClipBottleneck(planes * 4, planes, 1, g)
                   for _ in range(1, blocks)])

        self.layer1 = layer(w, w, cfg.layers[0], 1)
        self.layer2 = layer(w * 4, w * 2, cfg.layers[1], 2)
        self.layer3 = layer(w * 8, w * 4, cfg.layers[2], 2)
        self.layer4 = layer(w * 16, w * 8, cfg.layers[3], 2)
        self.attnpool = AttentionPool(cfg, g)


class AttentionPool(tnn.Module):
    """AttentionPool2d's leaves: the positional embedding `pos`
    (spacial_dim^2 + 1, embed_dim), q / k / v / c projections and the
    conv + BN residual `connect`."""

    def __init__(self, cfg: ClipVisualConfig, g=None):
        super().__init__()
        ed = cfg.embed_dim
        self.pos = nn.param(nn.normal_init((cfg.spacial_dim ** 2 + 1, ed), g,
                                           std=ed ** -0.5))
        self.q = nn.Linear(ed, ed, g=g)
        self.k = nn.Linear(ed, ed, g=g)
        self.v = nn.Linear(ed, ed, g=g)
        self.c = nn.Linear(ed, cfg.output_dim, g=g)
        self.connect = conv_bn(1, 1, ed, cfg.output_dim, g)


def init_modified_resnet(cfg: ClipVisualConfig, generator: torch.Generator,
                         device=None) -> ModifiedResNet:
    return ModifiedResNet(cfg, generator).to(nn.resolve_device(device))


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """nn.AvgPool2d(k) over NHWC: kernel = stride = k, no padding; the sum
    in f32, divided by k * k, rounded to x's dtype."""
    b, h, w, c = x.shape
    y = x[:, :h // k * k, :w // k * k].float()
    y = y.reshape(b, h // k, k, w // k, k, c).sum((2, 4))
    return (y / (k * k)).to(x.dtype)


def _clip_bottleneck(p: ClipBottleneck, x: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """clip.py Bottleneck: every conv at stride 1; an avgpool after conv2
    and before the downsample projection when stride > 1."""
    y = torch.relu(frozen_bn(p.c1.bn, nn.conv1x1(p.c1.conv, x)))
    y = torch.relu(frozen_bn(p.c2.bn, nn.conv2d(p.c2.conv, y)))
    if stride > 1:
        y = _avg_pool(y, stride)
    y = frozen_bn(p.c3.bn, nn.conv1x1(p.c3.conv, y))
    if hasattr(p, "down"):
        idn = _avg_pool(x, stride) if stride > 1 else x
        idn = frozen_bn(p.down.bn, nn.conv1x1(p.down.conv, idn))
    else:
        idn = x
    return torch.relu(y + idn)


def _attention_pool(p: AttentionPool, x: torch.Tensor, heads: int,
                    spacial_dim: int) -> torch.Tensor:
    """AttentionPool2d (clip.py:110-144): per-pixel QKV self-attention over
    the bicubic-resized positional embedding (the class row dropped), q
    scaled before its product, plus the conv + BN residual."""
    b, h, w, c = x.shape
    res = frozen_bn(p.connect.bn, nn.conv1x1(p.connect.conv, x))
    pos = p.pos[1:].reshape(spacial_dim, spacial_dim, c).to(x.dtype)
    mh = torch.from_numpy(_bicubic_axis_matrix(spacial_dim, h)).to(
        x.device, x.dtype)
    mw = torch.from_numpy(_bicubic_axis_matrix(spacial_dim, w)).to(
        x.device, x.dtype)
    pos = torch.einsum("Oh,hwc->Owc", mh, pos)
    pos = torch.einsum("Pw,hwc->hPc", mw, pos)

    t = x.reshape(b, h * w, c) + pos.reshape(1, h * w, c)
    hd = c // heads
    q = nn.linear(p.q, t).reshape(b, -1, heads, hd) * hd ** -0.5
    k = nn.linear(p.k, t).reshape(b, -1, heads, hd)
    v = nn.linear(p.v, t).reshape(b, -1, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits, -1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = nn.linear(p.c, out.reshape(b, h * w, c)).reshape(b, h, w, -1)
    return torch.relu(out + res)


def encode_image_resnet(p: ModifiedResNet, cfg: ClipVisualConfig,
                        image: torch.Tensor):
    """image (B, H, W, 3) -> (x2, x3, attention-pooled x4), the
    multi-scale return of clip.py:207-223."""
    x = image
    for name in ("stem1", "stem2", "stem3"):
        s = getattr(p, name)
        x = torch.relu(frozen_bn(s.bn, nn.conv2d(
            s.conv, x, stride=2 if name == "stem1" else 1)))
    x = _avg_pool(x, 2)
    for name, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2),
                         ("layer4", 2)):
        for j, blk in enumerate(getattr(p, name)):
            x = _clip_bottleneck(blk, x, stride if j == 0 else 1)
        if name == "layer2":
            x2 = x
        elif name == "layer3":
            x3 = x
    x4 = _attention_pool(p.attnpool, x, cfg.heads, cfg.spacial_dim)
    return x2, x3, x4


# ---------------------------------------------------------------------------
# the VisionTransformer visual tower (clip.py:286-332)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClipViTConfig:
    input_resolution: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class ClipViT(tnn.Module):
    """The JAX `init_clip_vit` tree."""

    def __init__(self, cfg: ClipViTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, d = generator, cfg.width
        scale = d ** -0.5
        grid = cfg.input_resolution // cfg.patch_size
        self.conv1 = nn.Conv(cfg.patch_size, cfg.patch_size, 3, d, g,
                             bias=False)
        self.class_embedding = nn.param(nn.normal_init((d,), g, std=scale))
        self.pos_embedding = nn.param(nn.normal_init((grid * grid + 1, d), g,
                                                     std=scale))
        self.ln_pre = nn.Norm(d)
        self.blocks = tnn.ModuleList(ClipBlock(d, g)
                                     for _ in range(cfg.layers))
        self.ln_post = nn.Norm(d)
        self.proj = nn.param(nn.normal_init((d, cfg.output_dim), g,
                                            std=scale))


def init_clip_vit(cfg: ClipViTConfig, generator: torch.Generator,
                  device=None) -> ClipViT:
    return ClipViT(cfg, generator).to(nn.resolve_device(device))


def encode_image_vit(p: ClipViT, cfg: ClipViTConfig,
                     image: torch.Tensor) -> torch.Tensor:
    """image (B, H, W, 3) -> projected grid tokens (B, gh * gw,
    output_dim): ln_post over x[:, 1:], the class token dropped."""
    x = nn.conv2d(p.conv1, image, stride=cfg.patch_size, padding="VALID")
    b, gh, gw, c = x.shape
    x = x.reshape(b, gh * gw, c)
    cls = p.class_embedding.to(x.dtype).expand(b, 1, c)
    x = torch.cat([cls, x], 1) + p.pos_embedding.to(x.dtype)
    x = nn.layer_norm(p.ln_pre, x, 1e-5)
    x = _blocks(p.blocks, x, cfg.heads, causal=False)
    x = nn.layer_norm(p.ln_post, x[:, 1:], 1e-5)
    return x @ p.proj.to(x.dtype)


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

BOS, EOS = 49406, 49407


def _bytes_to_unicode() -> Dict[int, str]:
    """The standard CLIP / GPT-2 byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BPETokenizer:
    """CLIP's byte-level BPE over a merges vocabulary file (the
    `bpe_simple_vocab_16e6.txt.gz` layout), so that CLIP checkpoints
    tokenize as they were trained; `byte_tokenizer` needs no file. Needs
    the `regex` package."""

    def __init__(self, merges_path: str):
        import regex
        opener = gzip.open if str(merges_path).endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]
                  if m]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {}
        self.pat = regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        import html
        text = html.unescape(html.unescape(text))
        text = " ".join(text.split()).strip().lower()
        ids: List[int] = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: List[str],
                 context_length: int = 77) -> np.ndarray:
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [BOS] + self.encode(t)[:context_length - 2] + [EOS]
            out[i, :len(ids)] = ids
        return out


def get_tokenizer(merges_path: Optional[str] = None):
    """The BPE tokenizer when the merges file exists, else
    `byte_tokenizer`."""
    import os
    if merges_path and os.path.exists(merges_path):
        return BPETokenizer(merges_path)
    return byte_tokenizer


def byte_tokenizer(texts: List[str], context_length: int = 77) -> np.ndarray:
    """BOS + utf-8 bytes + EOS, 0-padded (B, context_length) int32. Byte ids
    lie in [1, 256], so EOS stays the largest id (EOT pooling works)."""
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [BOS] + [b + 1 for b in t.encode("utf-8")][:context_length - 2]
        ids.append(EOS)
        out[i, :len(ids)] = ids
    return out
