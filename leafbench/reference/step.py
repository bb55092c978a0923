"""The train step and the eval forward in plain PyTorch: the device
augment, the loss, the backward, Adam with coupled L2 and the schedules.

The augment draws, from the step's generator and in this order: a
(B, 1) uniform for whether to apply gain (p 0.25), a (B, 1) uniform gain
in dB over [−18, 6], a (B, 1) uniform for whether to add noise (p 0.5),
a (B, 1) uniform amplitude over [0.001, 0.015], then (B, T) standard
normal noise; the clip is then divided by its peak where that exceeds 1
(the LEAF recipe's gain, noise and peak normalisation). The backbone
draws its masks after it (``reference/<arch>.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

BETAS, EPS = (0.9, 0.999), 1e-8


def augment(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    b = x.shape[0]

    def uniform(lo, hi):
        u = torch.rand((b, 1), generator=generator, device=x.device)
        return lo + (hi - lo) * u

    apply_gain = uniform(0.0, 1.0) < 0.25
    gain = torch.pow(10.0, uniform(-18.0, 6.0) / 20.0)
    x = torch.where(apply_gain, x * gain, x)
    apply_noise = uniform(0.0, 1.0) < 0.5
    amp = uniform(0.001, 0.015)
    noise = torch.randn(x.shape, generator=generator, device=x.device)
    x = torch.where(apply_noise, x + amp * noise, x)
    peak = x.abs().amax(dim=-1, keepdim=True)
    return torch.where(peak > 1.0, x / peak, x)


def loss_fn(model_type: str) -> Callable:
    """Mean softmax cross-entropy (multiclass, integer labels) or mean
    sigmoid binary cross-entropy over all elements (multilabel)."""
    if model_type == "multilabel":
        return lambda logits, y: F.binary_cross_entropy_with_logits(
            logits, y.float())
    return lambda logits, y: F.cross_entropy(logits, y.long())


def schedule(opt: dict, steps_per_epoch: int, epochs: int) -> Callable:
    """lr of the k-th update (k from 0): 'warmupcosine' (linear warm-up
    over warmup_epochs, then cosine to 0 at the end of ``epochs``) or
    'step' (× gamma every step_size epochs)."""
    base = float(opt.get("lr", 1e-3))
    name = opt.get("scheduler")
    if name == "warmupcosine":
        warm = steps_per_epoch * int(opt.get("warmup_epochs", 10))
        total = steps_per_epoch * epochs

        def lr(k):
            if k < warm:
                return base * k / max(1.0, warm)
            prog = min(max((k - warm) / max(1.0, total - warm), 0.0), 1.0)
            return base * 0.5 * (1.0 + math.cos(math.pi * prog))
        return lr
    if name == "step":
        size, gamma = int(opt.get("step_size", 30)), float(opt.get("gamma",
                                                                   0.1))
        return lambda k: base * gamma ** ((k // max(1, steps_per_epoch))
                                          // size)
    raise ValueError(f"the reference has no scheduler {name!r}")


class Adam:
    """Adam (β 0.9, 0.999, ε 1e-8) with coupled L2: g ← g + wd·p before
    the moments, every parameter decayed."""

    def __init__(self, params: List[torch.Tensor], wd: float):
        self.params, self.wd, self.t = params, wd, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - BETAS[0] ** self.t, 1.0 - BETAS[1] ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.wd * p
            m.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
            v.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + EPS))


class Trainer:
    """``model`` (train mode) stepped as the port's K-step entry steps it:
    per batch the augment, the loss, the backward and Adam at the step's
    lr. ``keep_rows`` (a planted fault for the control study) takes the
    loss over the first rows of each batch only."""

    def __init__(self, model, generator: Optional[torch.Generator],
                 model_type: str, wd: float,
                 keep_rows: Optional[int] = None):
        model.train()
        self.model, self.generator, self.keep_rows = model, generator, \
            keep_rows
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.opt = Adam(self.params, wd)
        self.lossf = loss_fn(model_type)

    def call(self, batches, lrs: List[float]):
        """One call: ``batches`` ((x f32 (B, T), y) pairs, one per step)
        at ``lrs``. Returns each step's loss and the first step's
        logits."""
        losses, first = [], None
        for (x, y), lr in zip(batches, lrs):
            x = augment(self.generator, x)
            logits = self.model(x, self.generator)
            if first is None:
                first = logits.detach().cpu()
            if self.keep_rows is not None:
                logits, y = logits[:self.keep_rows], y[:self.keep_rows]
            loss = self.lossf(logits, y)
            for p in self.params:
                p.grad = None
            loss.backward()
            self.opt.step(lr)
            losses.append(float(loss.detach()))
        return losses, first

    def state(self) -> Dict[str, object]:
        """Parameters and buffers, Adam's moments by parameter name and
        its step count, copied to the host."""
        return {"model": {k: v.detach().cpu().clone()
                          for k, v in self.model.state_dict().items()},
                "exp_avg": {n: m.cpu().clone()
                            for n, m in zip(self.names, self.opt.m)},
                "exp_avg_sq": {n: v.cpu().clone()
                               for n, v in zip(self.names, self.opt.v)},
                "step": self.opt.t}

    @torch.no_grad()
    def load(self, state: Dict[str, object]) -> None:
        """Continue from ``state`` (``state()``'s form)."""
        self.model.load_state_dict(state["model"])
        for n, m, v in zip(self.names, self.opt.m, self.opt.v):
            m.copy_(state["exp_avg"][n])
            v.copy_(state["exp_avg_sq"][n])
        self.opt.t = int(state["step"])


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for cuBLAS and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@torch.no_grad()
def eval_logits(model, x: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Eval-mode logits of (N, T) clips, ``block`` clips at a time."""
    model.eval()
    return torch.cat([model(x[i:i + block]) for i in range(0, x.shape[0],
                                                          block)])
