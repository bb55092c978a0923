"""The comparisons that decide ``correct``: the numbers a run compares
with its limits (``limits/<workload>.json``), each computed from what the
port produced and what the plain reference computes again.

Training (``train_numbers``): the first two calls of the timed entry (call
1: K eager steps, then the CUDA graph's capture; call 2: its first
replay), driven from the seed. Call 1 is held against the reference's K
steps from the same weights; for call 2 the reference starts again from
the port's own state after call 1 (parameters, buffers, Adam's moments and
step), so that the replay is judged alone and not through the rounding
that call 1 leaves behind. Both follow the same rows with the same
generator draws. Of each call (``call_readings``), by leaf: the norm of
the gradient as Adam got it over the call (from its second moment), of
what the call added to its first moment, and of each parameter's change;
and the call's mean loss. The numbers (``replay_`` for call 2):
- ``first_logit_gap``: the first step's logits (read by a hook before the
  CUDA graph is captured), max |port − ref| / max |ref|;
- ``loss_gap``: |L_port − L_ref| / |L_ref|, L the mean loss of the call's
  K steps;
- ``grad_gap``, ``moment_gap``: the worst leaf's
  |‖port‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖);
- ``change_gap``: the same, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off);
- ``replay_grad_median_gap``: the replay's gradient gap of the median
  leaf, steady from seed to seed where the worst leaf's swings with one
  small leaf (PCEN's smoothing weights on the AudioSet cell);
- ``rows_bad``: rows fed to the checked calls that are not one of the
  seed's clips with its labels, or that repeat (limit 0).

Serving (``logit_gap``): every request of the window, the worst clip's
max |logit_port − logit_ref| / max |logit_ref| of its request.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


BETAS = (0.9, 0.999)          # Adam's, the port's and the reference's


def leaf_gap(port: Dict[str, float], ref: Dict[str, float],
             names: Optional[List[str]] = None) -> float:
    """The worst leaf's gap of norms, against the larger of the leaf's
    reference norm and the median leaf's."""
    names = list(ref) if names is None else names
    med = float(np.median([ref[n] for n in ref]))
    return max((abs(port[n] - ref[n]) / max(ref[n], med, 1e-30)
                for n in names), default=0.0)


def median_gap(port: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median over the leaves of ``leaf_gap``'s terms."""
    med = float(np.median([ref[n] for n in ref]))
    return float(np.median([abs(port[n] - ref[n]) / max(ref[n], med, 1e-30)
                            for n in ref]))


def moving_leaves(grads: Dict[str, float], share: float = 1e-3
                  ) -> List[str]:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's."""
    med = float(np.median(list(grads.values())))
    return [n for n, v in grads.items() if v >= share * med]


def start_state(weights: Dict[str, torch.Tensor]) -> dict:
    """The state before the first call: the seed's weights, no moments."""
    return {"model": {k: v.detach().cpu() for k, v in weights.items()},
            "exp_avg": {}, "exp_avg_sq": {}, "step": 0}


def call_readings(before: dict, after: dict) -> Dict[str, Dict[str, float]]:
    """By parameter, from the states before and after one call
    (``reference.step.Trainer.state``'s form): ``grad`` the root of the
    squared gradients Adam took in over the call, (v_after − β2^t v_before)
    / (1 − β2); ``moment`` the norm of what it added to its first moment,
    (m_after − β1^t m_before) / (1 − β1); ``change`` the norm of the
    parameter's change."""
    t = int(after["step"]) - int(before["step"])
    out = {"grad": {}, "moment": {}, "change": {}}
    for n, m in after["exp_avg"].items():
        m0 = before["exp_avg"].get(n)
        v0 = before["exp_avg_sq"].get(n)
        dm = m if m0 is None else m - BETAS[0] ** t * m0
        dv = (after["exp_avg_sq"][n] if v0 is None
              else after["exp_avg_sq"][n] - BETAS[1] ** t * v0)
        out["grad"][n] = float(dv.double().sum().clamp(min=0.0).sqrt()
                               / (1.0 - BETAS[1]) ** 0.5)
        out["moment"][n] = float(dm.double().norm() / (1.0 - BETAS[0]))
        out["change"][n] = float((after["model"][n].double()
                                  - before["model"][n].double()).norm())
    return out


def train_numbers(start: dict, port: dict, ref: dict) -> Dict[str, float]:
    """``port``, ``ref``: {"losses": each call's mean loss, "states": the
    state after each call, "first_logits"}; the reference's second call
    started from ``port["states"][0]``."""
    before = [start, port["states"][0]]
    out = {"first_logit_gap": logit_gap(port["first_logits"].numpy(),
                                        ref["first_logits"].numpy())}
    for c, prefix in enumerate(("", "replay_")):
        p = call_readings(before[c], port["states"][c])
        r = call_readings(before[c], ref["states"][c])
        out[prefix + "loss_gap"] = abs(port["losses"][c] - ref["losses"][c]
                                       ) / abs(ref["losses"][c])
        out[prefix + "grad_gap"] = leaf_gap(p["grad"], r["grad"])
        out[prefix + "moment_gap"] = leaf_gap(p["moment"], r["moment"])
        out[prefix + "change_gap"] = leaf_gap(p["change"], r["change"],
                                              moving_leaves(r["grad"]))
    out["replay_grad_median_gap"] = median_gap(p["grad"], r["grad"])
    return out


def match_rows(rows: np.ndarray, clips: np.ndarray) -> np.ndarray:
    """The index in ``clips`` of each row of ``rows`` (−1 where none)."""
    where = {clip.tobytes(): i for i, clip in enumerate(clips)}
    return np.array([where.get(r.tobytes(), -1) for r in rows])


def rows_bad(index: np.ndarray, ys: torch.Tensor,
             targets: torch.Tensor) -> int:
    """Rows not matched, matched with other labels, or repeated."""
    bad = int((index < 0).sum())
    ok = index >= 0
    same = (ys.cpu()[torch.from_numpy(ok)] == targets[index[ok]])
    bad += int((~same.reshape(int(ok.sum()), -1).all(dim=1)).sum())
    return bad + int(ok.sum() - np.unique(index[ok]).size)


def logit_gap(port: np.ndarray, ref: np.ndarray) -> float:
    """max |port − ref| / max |ref| over one request's (N, classes)
    logits."""
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))
