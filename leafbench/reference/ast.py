"""AST, the Audio Spectrogram Transformer (Gong, Chung and Glass,
Interspeech 2021, arXiv:2104.01778; github.com/YuanGongND/ast
``src/models/ast_models.py`` ``ASTModel``), in plain PyTorch, float32, on
the 1-channel LEAF image (B, 1, F, frames) in place of AST's (B, 1, 128,
1024) fbank image.

With D = embed_dim, H = num_heads, d = D/H, p the 16 × 16 patches taken at
stride (fstride, tstride) and flattened frequency-major:

    x0   = [cls; dist; W_p · p] + pos                     (B, 2 + f·t, D)
    per block:
      q, k, v = split_H(LN₁(x) W_qkv + b_qkv)
      x += (softmax(q kᵀ / √d) v, heads merged) W_o + b_o
      x += GELU(LN₂(x) W_1 + b_1) W_2 + b_2               (exact GELU)
    logits = Linear(LN_h((LN(x)[0] + LN(x)[1]) / 2))

The image is (input_fdim, input_tdim), by default AST's 128 × 1024 as its
constructor's: the size that LEAF's 128 filters over 10.24 s give, which
the port derives from n_filters and random_clip_size. A model section
may name another (the tests' tiny cells); a forward on any other image
raises.

LayerNorms eps 1e-6 but the head's (1e-5, torch's default, as AST builds
it). The attention is written out: a matrix product, the softmax, a
matrix product. No dropout and no drop-path (DeiT-Base's rates are 0).

Departures from AST, each the benchmark's: LEAF's sPCEN features in place
of the normalised fbank (no mean −4.27 / std 4.57); random weights
(``weight_std``) in place of the ImageNet DeiT start; no SpecAugment and
no mixup (the device augment runs instead); Adam's β1 0.9 (AST's recipe
0.95; ``reference/step.py``).

Off the meta device each block runs under ``torch.utils.checkpoint``
(recomputed in the backward, the same numbers) so that the f32 reference
fits the card at the cell's batch; on the meta device it does not, so
``reference/flops.py`` counts no recompute. Nothing here is random at
train time.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

PATCH = 16


class Attention(nn.Module):
    def __init__(self, dim, heads, device):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        b, n, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1,
                                                                 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1))
                             * d ** -0.5, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, device):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, device):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.attn = Attention(dim, heads, device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, mlp_ratio * dim, device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _Params(nn.Module):
    """A holder of named parameters and modules (AST's names)."""


class Backbone(nn.Module):
    """AST on the (B, 1, F, frames) image → logits."""

    def __init__(self, cfg_model: dict, device=None):
        super().__init__()
        dim = int(cfg_model["embed_dim"])
        fs, ts = int(cfg_model["fstride"]), int(cfg_model["tstride"])
        self.image = (int(cfg_model.get("input_fdim", 128)),
                      int(cfg_model.get("input_tdim", 1024)))
        f_dim = (self.image[0] - PATCH) // fs + 1
        t_dim = (self.image[1] - PATCH) // ts + 1
        v = self.v = _Params()
        v.patch_embed = _Params()
        v.patch_embed.proj = nn.Conv2d(1, dim, PATCH, stride=(fs, ts),
                                       device=device)
        v.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        v.dist_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        v.pos_embed = nn.Parameter(torch.zeros(1, 2 + f_dim * t_dim, dim,
                                               device=device))
        v.blocks = nn.ModuleList(
            Block(dim, int(cfg_model["num_heads"]),
                  int(cfg_model["mlp_ratio"]), device)
            for _ in range(int(cfg_model["depth"])))
        v.norm = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.mlp_head = nn.Sequential(
            nn.LayerNorm(dim, device=device),
            nn.Linear(dim, int(cfg_model["num_classes"]), device=device))

    def forward(self, x, generator=None):
        if tuple(x.shape[2:]) != self.image:
            raise ValueError(f"AST's image is {self.image}, got "
                             f"{tuple(x.shape[2:])}")
        v = self.v
        x = v.patch_embed.proj(x).flatten(2).transpose(1, 2)
        b = x.shape[0]
        x = torch.cat([v.cls_token.expand(b, -1, -1),
                       v.dist_token.expand(b, -1, -1), x], dim=1)
        x = x + v.pos_embed
        for block in v.blocks:
            if x.device.type == "meta" or not torch.is_grad_enabled():
                x = block(x)
            else:
                x = checkpoint(block, x, use_reentrant=False)
        x = v.norm(x)
        return self.mlp_head((x[:, 0] + x[:, 1]) / 2)


def weight_std(name: str, shape: tuple) -> Optional[float]:
    """0.02 for the Linear and patch-conv weights and the cls, dist and
    position tokens; None (LayerNorm scales keep 1) otherwise."""
    if name.endswith(("cls_token", "dist_token", "pos_embed")):
        return 0.02
    if name.endswith("weight") and len(shape) >= 2:
        return 0.02
    return None
