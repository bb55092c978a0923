#!/usr/bin/env python
"""How far a K-step CUDA-graph replay of the port's train step is from
the same steps run eagerly, with and without deterministic algorithms.

Runs the card test helper ``tests/test_torch_port_cuda.py::
_replay_against_eager`` (a K = 3 replay at B=8 against 3 eager steps
from copies of the same state and generator state; augment, dropout and
drop-connect on) N times for each of f32 / bf16 × deterministic on /
off, and prints per run: whether the losses are bit-equal, the loss
difference in bf16 ulps of the loss, the `correct` counts, how many
state tensors differ, the update difference relative to the update's
norm, the logits' dtype, and the clips whose top two logits lie within
one bf16 ulp.

Needs a CUDA card and PyTorch only (no JAX). Run from the repository
root:

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python scripts/replay_determinism.py [N]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def report(t, device, bf16: bool, det: bool, n: int) -> None:
    import torch
    torch.backends.cudnn.deterministic = det
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(det, warn_only=True)
    bf16_eps = torch.finfo(torch.bfloat16).eps
    for i in range(n):
        got, ref, st, twin, p0, gen, tgen, logits = t._replay_against_eager(
            device, bf16)
        ref_loss = torch.stack([m["loss"] for m in ref]).float().mean()
        loss = got["loss"].float()
        differ = [k for (k, a), b in zip(st.model.state_dict().items(),
                                         twin.model.state_dict().values())
                  if not torch.equal(a, b)]
        num = den = 0.0
        with torch.no_grad():
            for p, q, r in zip(st.model.parameters(),
                               twin.model.parameters(), p0):
                num += float(((p - q) ** 2).sum())
                den += float(((q - r) ** 2).sum())
        ties = 0
        for out in logits:
            top2 = out.float().topk(2, dim=-1).values
            ties += int(((top2[:, 0] - top2[:, 1])
                         <= bf16_eps * top2[:, 0].abs()).sum())
        print(f"bf16={bf16} deterministic={det} run {i}: loss bit-equal "
              f"{bool(torch.equal(loss, ref_loss))}, |diff| "
              f"{float((loss - ref_loss).abs() / (bf16_eps * ref_loss.abs())):.3f}"
              f" bf16 ulps; correct {int(got['correct'])} vs "
              f"{sum(int(m['correct']) for m in ref)}; {len(differ)} state "
              f"tensors differ; update rel {(num / den) ** 0.5:.3e}; logits "
              f"{logits[0].dtype}; near-ties {ties}; generators equal "
              f"{bool(gen.get_state().equal(tgen.get_state()))}", flush=True)


def main(argv=None) -> int:
    import torch
    n = int((argv or sys.argv[1:] or ["4"])[0])
    if not torch.cuda.is_available():
        print("replay_determinism: needs a CUDA device", file=sys.stderr)
        return 1
    import tests.test_torch_port_cuda as t
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    for det in (True, False):
        for bf16 in (False, True):
            report(t, device, bf16, det, n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
