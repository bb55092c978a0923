"""The frozen yardstick: work counts and bounds, FLOP counts, the
timeline's busy and idle time, and the per-layer readers."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from leafbench.measure import categories, readers, trace, work
from leafbench.reference import flops


def test_frontend_work_by_hand():
    b, t, f = 2, 1600, 4
    frames = (t + 400 - 401) // 160 + 1
    assert work.frames_out(t) == frames == 10
    fwd = work.frontend_work(b, t, f, 4, "fwd")
    assert fwd["tc_flops"] == 3 * 2 * b * t * 2 * f * 401
    assert fwd["flops"] == 3 * b * t * f + 2 * b * frames * f * 401
    assert fwd["nbytes"] == 4 * (b * t + 401 * 2 * f + f * 401
                                 + b * frames * f)
    save = work.frontend_work(b, t, f, 4, "fwd_save")
    assert save["nbytes"] - fwd["nbytes"] == 4 * b * 2 * f * t
    bwd = work.frontend_work(b, t, f, 2, "bwd")
    covered = sum(min(160 * fr + 201, t) - max(160 * fr - 200, 0)
                  for fr in range(frames))
    assert bwd["flops"] == 7 * b * t * f + 4 * b * f * covered
    assert bwd["tc_flops"] == 2 * b * t * 2 * f * 401
    assert bwd["tc_peak"] == work.BF16_PEAK_FLOPS
    got = work.bound(**fwd)
    flop_ms = (fwd["flops"] / 67e12 + fwd["tc_flops"] / 494.7e12) * 1e3
    assert got["bound_ms"] == pytest.approx(max(
        flop_ms, fwd["nbytes"] / 3.35e12 * 1e3))
    assert work.frontend_bound_ms([("fwd", b, t, f, 4)] * 2) == \
        pytest.approx(2 * got["bound_ms"])
    with pytest.raises(ValueError):
        work.frontend_work(b, t, f, 4, "other")


def test_grouped_conv_flops_by_hand():
    x = torch.randn(2, 6, 10, 10)
    w = torch.randn(6, 1, 3, 3, requires_grad=True)
    with FlopCounterMode(display=False,
                         custom_mapping=flops._CONV) as counter:
        F.conv2d(x, w, padding=1, groups=6).sum().backward()
    fwd = 2 * 2 * 6 * 10 * 10 * 9
    assert counter.get_total_flops() == 2 * fwd   # forward + d_weight


def test_model_flops_at_a_tiny_shape():
    cfg = {"frontend": {"name": "leaf", "default_args": False,
                        "n_filters": 8},
           "audio_config": {"sample_rate": 16000},
           "model": {"arch": "resnet", "model_depth": 18, "num_classes": 5,
                     "pool": "avgpool", "type": "multilabel"}}
    b, t = 2, 4000
    gabor = 2 * b * t * 16 * 401
    lowpass = 2 * b * 8 * work.frames_out(t) * 401
    fwd = flops.count(cfg, b, t, train=False)
    train = flops.count(cfg, b, t, train=True)
    assert fwd > gabor + lowpass
    # the waveform takes no gradient: the Gabor conv's backward is d_bank
    # only; every other conv and product counts twice more
    assert train == pytest.approx(3 * fwd - gabor, rel=1e-9)


def _timeline():
    dev = [("k_a", 10, 20), ("k_b", 15, 30), ("k_c", 50, 60), ("k_d", 0, 5)]
    host = [("op", 0, 100), ("inner", 32, 48)]
    spans = {trace.WINDOW: [(5, 95)],
             "leafbench.request": [(5, 40), (40, 95)]}
    return trace.Timeline(dev, host, spans)


def test_timeline_busy_idle_and_gaps():
    tl = _timeline()
    assert tl.window_s == pytest.approx(90e-9)
    assert tl.busy_s == pytest.approx(30e-9)      # [10, 30] and [50, 60]
    got = tl.busy_within_s(np.array([5, 40]), np.array([40, 95]))
    assert got == pytest.approx([20e-9, 10e-9])
    assert tl.device_rows() == pytest.approx({"k_a": 10e-9, "k_b": 15e-9,
                                              "k_c": 10e-9})
    # gaps [5, 10], [30, 50], [60, 95] by the innermost host op or span
    assert tl.idle_gaps() == pytest.approx({"leafbench.request": 40e-9,
                                            "inner": 20e-9})
    ctx = {"kind": "serve", "timeline": tl, "units": 2}
    assert readers.idle_share(ctx, "serve") == pytest.approx(100 * 60 / 90)
    assert readers.idle_share(ctx, "train") is None
    assert readers.dispatch_ms(ctx, "leafbench.request") == \
        pytest.approx((90 - 30) * 1e-6 / 2)


def test_readers_find_nothing_without_a_trace():
    ctx = {"kind": "train", "timeline": None, "units": 3,
           "frontend_calls": [("fwd", 1, 1600, 4, 4)]}
    assert readers.per_unit_ms(ctx, "train", categories.BACKBONE) is None
    assert readers.frontend_roofline(ctx, "train") is None
    assert readers.idle_share(ctx, "train") is None


def test_categories_of_the_h100s_kernel_names():
    cat = categories.category
    assert cat("void (anonymous namespace)::fused_fwd_tf32x3_kernel<true>"
               "(float const*)") == categories.FRONTEND
    assert cat("void at::native::(anonymous namespace)::"
               "conv_depthwise2d_grad_weight_kernel<float>") == \
        categories.DEPTHWISE
    assert cat("void cudnn::bn_bw_1C11_kernel_new<float>") == \
        categories.BATCHNORM
    assert cat("sm80_xmma_fprop_implicit_gemm_f32f32") == categories.CONV_GEMM
    assert cat("void DSE::vector_fft<0, 1, 128>") == categories.CONV_GEMM
    assert cat("void pointwise_mult_and_sum_complex<float2, 8, 4>") == \
        categories.CONV_GEMM
    assert cat("void at::native::vectorized_elementwise_kernel<4>") == \
        "elementwise/reductions"
    assert cat("some_new_kernel") == categories.OTHER
