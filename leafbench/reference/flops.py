"""Model FLOPs of the reference at a cell's shapes, counted by
``torch.utils.flop_counter.FlopCounterMode`` (convolutions and matrix
products) on the meta device, with the convolutions counted here so that
grouped ones count right (2 × output elements × C_in/groups × kernel
for the forward, and as much again for each gradient the backward
computes): forward and backward for a train step (no
recompute; the waveform takes no gradient, so the frontend's backward
counts only the bank's), the forward for scoring. The count reads the
same work whatever later computes it."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from leafbench.reference.classifier import Classifier
from leafbench.reference.step import loss_fn

aten = torch.ops.aten


def _conv_flops(x_shape, w_shape, out_shape, transposed) -> int:
    """2 × MACs of a (possibly grouped or transposed) convolution."""
    dense_out = x_shape if transposed else out_shape
    per_out = 1
    for d in w_shape[1:]:
        per_out *= d
    n = 1
    for d in dense_out:
        n *= d
    return 2 * n * per_out


def _conv(x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
          *args, out_shape=None, **kwargs) -> int:
    return _conv_flops(x_shape, w_shape, out_shape, transposed)


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride,
                   _padding, _dilation, transposed, _output_padding,
                   _groups, output_mask, out_shape=None) -> int:
    fwd = _conv_flops(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


_CONV = {aten.convolution: _conv, aten._convolution: _conv,
         aten.convolution_backward: _conv_backward}


def count(cfg: dict, batch: int, samples: int, train: bool) -> float:
    model = Classifier(cfg, device="meta")
    x = torch.empty(batch, samples, device="meta")
    with FlopCounterMode(display=False, custom_mapping=_CONV) as counter:
        if train:
            model.train()
            logits = model(x)
            if cfg["model"]["type"] == "multilabel":
                y = torch.empty(logits.shape, device="meta")
            else:
                y = torch.zeros(batch, dtype=torch.int64, device="meta")
            loss_fn(cfg["model"]["type"])(logits, y).backward()
        else:
            model.eval()
            with torch.no_grad():
                model(x)
    return float(counter.get_total_flops())
