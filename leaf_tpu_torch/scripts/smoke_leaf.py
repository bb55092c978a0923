"""Forward-pass smoke of the LEAF frontend, the counterpart of the JAX
repo's ``scripts/smoke_leaf.py`` (reference: test_leaf.py:1-12): build
``Leaf()`` with its default arguments (``use_fused_kernel="auto"``, so on
the card the forward is the fused primal kernel, ``fused_fwd``), run a
random 1 s waveform drawn from a ``torch.Generator`` seeded 0, and print
the shapes and the value range.

    python -m leaf_tpu_torch.scripts.smoke_leaf [--device cpu]

Prints ``input: (1, 16000)``, ``output: (1, 100, 40)`` and
``min/max/mean: ...``. Runs on the card unless ``--device cpu`` is
given; without a card it raises instead of falling back to the CPU.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.frontend import Leaf

SAMPLES = 16000


def smoke(device) -> Tuple[Leaf, torch.Tensor, torch.Tensor]:
    """(the frontend, the (1, 16000) waveform, its (1, 100, 40) features)
    on ``device``; the parameters are Leaf's deterministic mel init."""
    device = resolve_device(device)
    leaf = Leaf(device=device, generator=torch.Generator().manual_seed(1))
    x = torch.randn((1, SAMPLES),
                    generator=torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        out = leaf(x)
    return leaf, x, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    _, x, out = smoke(args.device)
    print("input:", tuple(x.shape))
    print("output:", tuple(out.shape))  # (1, 100, 40)
    print("min/max/mean:", float(out.min()), float(out.max()),
          float(out.mean()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
