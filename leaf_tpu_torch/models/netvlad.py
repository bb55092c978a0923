"""NetVLAD pooling head (NCHW), as two contractions.

Parity with the JAX package's ``leaf_tpu.models.netvlad`` and the
reference's 16-cluster NetVLAD (reference: models/netvlad.py:10-65). The
residual sum is computed as

    vlad[b,k,c] = Σ_n a[b,n,k]·x[b,n,c] − (Σ_n a[b,n,k])·centroid[k,c]

rather than by materialising the reference's (B, K, C, N) broadcast.
Parameter names are the reference's: ``centroids`` (K, C), and the
soft-assignment 1×1 conv ``conv.weight`` (K, C, 1, 1) / ``conv.bias``
(K,); a ResNet holds the module as ``avgpool``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["NetVLAD"]


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12
                  ) -> torch.Tensor:
    """x / max(‖x‖, eps) along ``dim`` (torch ``F.normalize``)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class NetVLAD(nn.Module):
    """(B, C, H, W) → (B, num_clusters · C) VLAD descriptor.

    Init as the reference's: centroids ~ U[0, 1); the assignment conv's
    weight = 2α·c and bias = −α·‖c‖, computed from the drawn centroids
    (models/netvlad.py:35-41), and trained on their own thereafter. The
    numbers are drawn on the CPU from ``generator``.
    """

    def __init__(self, num_clusters: int = 16, dim: int = 512,
                 alpha: float = 100.0, normalize_input: bool = True,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.alpha = alpha
        self.normalize_input = normalize_input
        self.centroids = nn.Parameter(
            torch.empty(num_clusters, dim, device=device))
        self.conv = nn.Conv2d(dim, num_clusters, 1, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        c = torch.rand(self.centroids.shape, generator=generator)
        self.centroids.copy_(c)
        self.conv.weight.copy_((2.0 * self.alpha * c)[:, :, None, None])
        self.conv.bias.copy_(-self.alpha * c.norm(dim=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        if self.normalize_input:
            x = _l2_normalize(x, dim=1)
        flat = x.flatten(2)                                  # (B, C, N)
        weight = self.conv.weight.flatten(1).to(x.dtype)     # (K, C)
        logits = (torch.einsum("bcn,kc->bnk", flat, weight)
                  + self.conv.bias.to(x.dtype))
        assign = torch.softmax(logits, dim=-1)               # (B, N, K)
        weighted = torch.einsum("bnk,bcn->bkc", assign, flat)
        mass = assign.sum(dim=1)                             # (B, K)
        vlad = weighted - mass[:, :, None] * self.centroids.to(x.dtype)[None]
        vlad = _l2_normalize(vlad, dim=-1)                   # intra-norm
        return _l2_normalize(vlad.reshape(b, -1), dim=-1)
