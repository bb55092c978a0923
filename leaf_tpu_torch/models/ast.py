"""AST, the Audio Spectrogram Transformer, as a LEAF backbone.

Gong, Chung and Glass, "AST: Audio Spectrogram Transformer", Interspeech
2021 (arXiv:2104.01778); code github.com/YuanGongND/ast,
``src/models/ast_models.py`` ``ASTModel``: a DeiT-Base distilled ViT over
the (frequency × time) image, here LEAF's (n_filters × frames) features
in place of AST's 128-bin log-mel fbank.

- Input: the NHWC (B, F, frames, 1) image the classifier builds, viewed
  as AST's (B, 1, F, frames) (its ``unsqueeze(1).transpose(2, 3)``).
- Patch embedding ``v.patch_embed.proj``: Conv2d(1, D, 16, stride
  (fstride, tstride)), flattened frequency-major (token f·t_dim + t).
- Tokens: ``v.cls_token`` and ``v.dist_token`` first, then the patches;
  ``v.pos_embed`` (1, 2 + f_dim·t_dim, D) added.
- ``depth`` pre-LN blocks ``v.blocks.N``: x += proj(attn(norm1(x))), qkv
  Linear(D, 3D) with bias, ``num_heads`` heads of D/heads at scale
  (D/heads)^−½ through ``F.scaled_dot_product_attention``; x +=
  fc2(GELU(fc1(norm2(x)))), fc1 D → mlp_ratio·D, exact (erf) GELU.
  LayerNorm eps 1e-6. No dropout and no drop-path (DeiT-Base's 0).
- Head: ``v.norm``, the mean of tokens 0 and 1, ``mlp_head`` =
  LayerNorm(D) (torch's eps 1e-5, as AST builds it) → Linear(D, classes).

Parameter names are AST's (``v.*``, ``mlp_head.*``), so a state_dict
under them loads. Init (timm's ViT) draws from ``generator`` on the CPU:
the Linear weights, the two tokens and the positions from N(0, 0.02²)
truncated at ±2, Linear biases 0, LayerNorm 1 and 0; the patch conv as
AST's fresh ``nn.Conv2d``, uniform over ±1/√256 for weight and bias.

The image's size (``input_fdim`` × ``input_tdim``) sizes the token grid
and the positions; ``Classifier`` passes the frontend's (n_filters,
frames of a ``random_clip_size`` clip). The other sizes default to AST's
published ones in ``ASTModel``'s signature; ``ast_options`` reads and
checks those of a config's ``model`` section.

Each block's attention core, from the q, k and v views to the merged
heads, runs between the device markers of ``tracing.ATTENTION_MARKS``.
bf16 compute is not supported yet: ``compute_dtype=bfloat16`` raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from leaf_tpu_torch import tracing
from leaf_tpu_torch.models.common import _drawn

__all__ = ["ASTModel", "get_shape", "ast_options"]

AST_PATCH = 16
LN_EPS = 1e-6
TOKEN_STD = 0.02
# the sizes a config's ``model`` section may set (``ASTModel``'s keywords)
OPTIONS = ("fstride", "tstride", "embed_dim", "depth", "num_heads",
           "mlp_ratio")


def get_shape(fstride: int, tstride: int, input_fdim: int,
              input_tdim: int) -> Tuple[int, int]:
    """(f_dim, t_dim): the patch grid of a (input_fdim, input_tdim)
    image, as AST's ``get_shape`` reads it off its 16 × 16 conv."""
    return ((input_fdim - AST_PATCH) // fstride + 1,
            (input_tdim - AST_PATCH) // tstride + 1)


def ast_options(model: dict) -> dict:
    """The AST sizes a config's ``model`` section sets (``OPTIONS``; the
    rest keep ``ASTModel``'s defaults), each checked to be a whole number
    >= 1. Raises ``ValueError``."""
    opts = {k: model[k] for k in OPTIONS if k in model}
    for k, v in opts.items():
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise ValueError(f"model.{k} must be a whole number >= 1, "
                             f"got {v!r}")
    return opts


@torch.no_grad()
def _trunc_normal_(t: torch.Tensor, generator) -> None:
    t.copy_(_drawn(t.shape, lambda c, g: nn.init.trunc_normal_(
        c, 0.0, TOKEN_STD, -2.0, 2.0, generator=g), generator, t))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def _core(self, q, k, v):
        b, h, n, d = q.shape
        out = F.scaled_dot_product_attention(q, k, v, scale=self.scale)
        return out.transpose(1, 2).reshape(b, n, h * d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.num_heads,
                                   c // self.num_heads).permute(
                                       2, 0, 3, 1, 4).unbind(0)
        return self.proj(tracing.attention(self._core, q, k, v))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = Attention(dim, num_heads, device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = Mlp(dim, mlp_ratio * dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, stride: Tuple[int, int], device=None):
        super().__init__()
        self.proj = nn.Conv2d(1, dim, AST_PATCH, stride=stride,
                              device=device)


class _ViT(nn.Module):
    """The DeiT-Base distilled ViT under timm's names (AST's ``v``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, mlp_ratio: int,
                 stride: Tuple[int, int], n_patches: int, device=None):
        super().__init__()
        self.patch_embed = _PatchEmbed(dim, stride, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 2, dim,
                                                  device=device))
        self.blocks = nn.ModuleList(Block(dim, num_heads, mlp_ratio, device)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)


class ASTModel(nn.Module):
    """AST on the (B, input_fdim, input_tdim, 1) LEAF image → (B,
    num_classes) logits; the sizes default to AST's published ones."""

    def __init__(self, num_classes: int = 527, fstride: int = 10,
                 tstride: int = 10, input_fdim: int = 128,
                 input_tdim: int = 1024, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if compute_dtype != torch.float32:
            raise ValueError(f"AST runs in float32 only: bf16 AST is not "
                             f"supported yet (compute_dtype {compute_dtype})")
        if min(input_fdim, input_tdim) < AST_PATCH:
            raise ValueError(f"AST's image ({input_fdim} x {input_tdim}) "
                             f"is less than one {AST_PATCH} x {AST_PATCH} "
                             f"patch")
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.compute_dtype = compute_dtype
        self.input_shape = (input_fdim, input_tdim)
        f_dim, t_dim = get_shape(fstride, tstride, input_fdim, input_tdim)
        self.v = _ViT(embed_dim, depth, num_heads, mlp_ratio,
                      (fstride, tstride), f_dim * t_dim, device)
        self.mlp_head = nn.Sequential(
            nn.LayerNorm(embed_dim, device=device),
            nn.Linear(embed_dim, num_classes, device=device))
        self._init(generator)

    @torch.no_grad()
    def _init(self, generator: Optional[torch.Generator]) -> None:
        conv = self.v.patch_embed.proj
        bound = 1.0 / math.sqrt(conv.weight[0].numel())
        for p in (conv.weight, conv.bias):
            p.copy_(_drawn(p.shape, lambda t, g: t.uniform_(
                -bound, bound, generator=g), generator, p))
        for p in (self.v.cls_token, self.v.dist_token, self.v.pos_embed):
            _trunc_normal_(p, generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _trunc_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits; ``generator`` is unused (nothing here is random)."""
        if tuple(x.shape[1:]) != self.input_shape + (1,):
            raise ValueError(
                f"AST takes the (B, input_fdim, input_tdim, 1) = (B, "
                f"{self.input_shape[0]}, {self.input_shape[1]}, 1) image, "
                f"got {tuple(x.shape)}: its clips must have the length "
                f"of audio_config.random_clip_size")
        v = self.v
        x = v.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(
            1, 2)
        b = x.shape[0]
        x = torch.cat((v.cls_token.expand(b, -1, -1),
                       v.dist_token.expand(b, -1, -1), x), dim=1)
        x = x + v.pos_embed
        for block in v.blocks:
            x = block(x)
        x = v.norm(x)
        return self.mlp_head((x[:, 0] + x[:, 1]) / 2)
