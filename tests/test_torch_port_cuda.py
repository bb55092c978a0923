"""The port's CUDA kernels on the card: edge shapes and the paths around them.

Every test takes the ``cuda_device`` fixture and skips without a card:
the kernels have no CPU mode (their plain versions are held against the
JAX op in tests/test_torch_port_fused.py). This file imports no JAX, so it runs
on a machine that has only PyTorch; the repository's root conftest.py
imports JAX, hence on the card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerance, kernel vs plain version (TF32 off): |d| ≤ 1e-4·|ref| +
1e-6·max|ref| for forward values — the kernels sum the 401-tap products
on the tensor cores in 3×TF32 (~22 bits per product), the plain versions
in float32; gradients to 1e-4 of their norm and of their largest entry
(d_bank sums B·T products per entry on the tensor cores in 3×TF32,
~1.5e-5 of the norm at B=256, T=16000).
"""

import numpy as np
import pytest
import torch

from leaf_tpu_torch.frontend import Leaf
from leaf_tpu_torch.ops import fused_frontend as fused
from leaf_tpu_torch.serving import ServingModel

K = 401
CFG = {"frontend": {"name": "leaf", "default_args": True},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": 35}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(b, t, f, device, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t).astype("float32") * 0.1
    gabor = rng.randn(K, 2 * f).astype("float32") * 0.05
    windows = np.abs(rng.randn(f, K)).astype("float32") * 0.01
    return (torch.from_numpy(a).to(device) for a in (x, gabor, windows))


def _assert_close(got, ref):
    bound = 1e-4 * ref.abs() + 1e-6 * ref.abs().max()
    assert got.shape == ref.shape
    assert bool(((got - ref).abs() <= bound).all()), float(
        (got - ref).abs().max())


# the forwards take 20 channels per block (F=20: one full group, F=21:
# one channel over) and walk their S span in 256-position chunks of four
# 64-position tiles: at T=1000 the span ends inside a chunk's third tile;
# T % 4 != 0 takes the 4-byte waveform copies
@pytest.mark.parametrize("b,t,f", [
    (1, 1, 40), (3, 159, 40), (2, 160, 40), (2, 161, 40), (2, 3041, 40),
    (5, 12345, 24), (4, 16000, 3), (2, 16000, 64), (1, 48000, 40),
    (300, 16000, 8), (2, 16000, 20), (3, 16000, 21), (2, 1000, 20),
    (3, 4037, 21),
])
def test_kernel_matches_plain(cuda_device, b, t, f):
    x, gabor, windows = _operands(b, t, f, cuda_device)
    before = fused.fused_forward_cuda.launches
    got = fused.fused_gabor_sqmod_lowpass(x, gabor, windows)
    torch.cuda.synchronize()
    assert fused.fused_forward_cuda.launches == before + 1
    _assert_close(got, fused.fused_reference(x, gabor, windows))


def test_misaligned_waveform(cuda_device):
    # contiguous, T % 4 == 0, but x starts 4 bytes past a 16-byte boundary:
    # the kernels take the 4-byte waveform copies
    x, gabor, windows = _operands(3, 16000, 40, cuda_device)
    flat = torch.empty(x.numel() + 1, device=cuda_device)
    xs = flat[1:].view_as(x)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    out, conv = fused.fused_forward_saving_cuda(xs, gabor, windows)
    ref_out, ref_conv = fused.fused_forward_saving_reference(x, gabor, windows)
    _assert_close(fused.fused_forward_cuda(xs, gabor, windows), ref_out)
    _assert_close(out, ref_out)
    _assert_close(conv, ref_conv)


def test_forwards_are_deterministic(cuda_device):
    x, gabor, windows = _operands(64, 16000, 40, cuda_device)
    assert torch.equal(fused.fused_forward_cuda(x, gabor, windows),
                       fused.fused_forward_cuda(x, gabor, windows))
    first = fused.fused_forward_saving_cuda(x, gabor, windows)
    second = fused.fused_forward_saving_cuda(x, gabor, windows)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_non_contiguous_input(cuda_device):
    x, gabor, windows = _operands(4, 16000, 40, cuda_device)
    xs = x[:, ::2]  # the op makes its operands contiguous for the wrapper
    _assert_close(fused.fused_gabor_sqmod_lowpass(xs, gabor, windows),
                  fused.fused_reference(xs, gabor, windows))
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_forward_cuda(xs, gabor, windows)


def test_wrapper_refusals(cuda_device):
    x, gabor, windows = _operands(2, 16000, 40, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        fused.fused_forward_cuda(x.bfloat16(), gabor, windows)
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_forward_cuda(x, gabor.cpu(), windows)
    with pytest.raises(ValueError, match="windows"):
        fused.fused_forward_cuda(x, gabor, windows[:-1])


def _assert_grad_close(got, ref):
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    diff = (got - ref).abs()
    assert float((got - ref).norm() / ref.norm()) <= 1e-4
    assert float(diff.max() / ref.abs().max()) <= 1e-4


# the backward takes 40 channels per block and 32-position chunks, split
# over one block per SM: (2, 16000, 64) needs two channel groups (2F =
# 128 > 80), (3, 20, 40) is shorter than a chunk, (7, 1000, 40) leaves a
# ragged last chunk per row and uneven runs of chunks per block; the
# saving forward's 20-channel groups: (2, 3041, 20) one full group,
# (2, 1000, 21) one channel over, with its S span ending mid-chunk
EDGE = [(1, 1, 40), (3, 159, 3), (3, 161, 24), (1, 12345, 40),
        (1, 48000, 24), (300, 161, 40), (300, 16000, 3), (2, 16000, 64),
        (3, 20, 40), (7, 1000, 40), (300, 16000, 40), (2, 3041, 20),
        (2, 1000, 21)]


@pytest.mark.parametrize("b,t,f", EDGE)
def test_saving_kernel_matches_plain(cuda_device, b, t, f):
    x, gabor, windows = _operands(b, t, f, cuda_device)
    before = fused.fused_forward_saving_cuda.launches
    out, conv = fused.fused_forward_saving_cuda(x, gabor, windows)
    torch.cuda.synchronize()
    assert fused.fused_forward_saving_cuda.launches == before + 1
    ref_out, ref_conv = fused.fused_forward_saving_reference(x, gabor, windows)
    _assert_close(out, ref_out)
    _assert_close(conv, ref_conv)


@pytest.mark.parametrize("b,t,f", EDGE)
def test_backward_kernel_matches_plain(cuda_device, b, t, f):
    x, gabor, windows = _operands(b, t, f, cuda_device)
    out, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    d_out = torch.randn(out.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    before = fused.fused_backward_cuda.launches
    d_bank, d_win = fused.fused_backward_cuda(x, conv, windows, d_out)
    torch.cuda.synchronize()
    assert fused.fused_backward_cuda.launches == before + 1
    ref_bank, ref_win = fused.fused_backward_reference(x, conv, windows,
                                                       d_out)
    _assert_grad_close(d_bank, ref_bank)
    _assert_grad_close(d_win, ref_win)


def test_backward_is_deterministic(cuda_device):
    # blocks of ~240 chunks: several accumulator flushes per block
    x, gabor, windows = _operands(64, 16000, 40, cuda_device)
    out, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    d_out = torch.randn(out.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device)
    first = fused.fused_backward_cuda(x, conv, windows, d_out)
    second = fused.fused_backward_cuda(x, conv, windows, d_out)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_backward_raises_on_card(cuda_device):
    """The op under autograd on the card runs the saving forward and the
    backward kernel: bank and window gradients as autograd's through the
    plain forward, the waveform gradient exactly zero."""
    x, gabor, windows = _operands(2, 16000, 40, cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, gabor, windows)]
    d_out = torch.randn(2, 100, 40, device=cuda_device)
    counts = (fused.fused_forward_saving_cuda.launches,
              fused.fused_backward_cuda.launches)
    dx, dg, dw = torch.autograd.grad(
        fused.fused_gabor_sqmod_lowpass(*leaves), leaves, d_out)
    torch.cuda.synchronize()
    assert (fused.fused_forward_saving_cuda.launches,
            fused.fused_backward_cuda.launches) == (counts[0] + 1,
                                                    counts[1] + 1)
    assert dx.shape == x.shape and not bool(dx.abs().max())
    g, w = gabor.clone().requires_grad_(), windows.clone().requires_grad_()
    rg, rw = torch.autograd.grad(fused.fused_reference(x, g, w), (g, w), d_out)
    _assert_grad_close(dg, rg)
    _assert_grad_close(dw, rw)


def test_backward_wrapper_refusals(cuda_device):
    x, gabor, windows = _operands(2, 16000, 40, cuda_device)
    _, conv = fused.fused_forward_saving_cuda(x, gabor, windows)
    d_out = torch.zeros(2, 100, 40, device=cuda_device)
    with pytest.raises(ValueError, match="conv"):
        fused.fused_backward_cuda(x, conv[:, :-2], windows, d_out)
    with pytest.raises(ValueError, match="d_out"):
        fused.fused_backward_cuda(x, conv, windows, d_out[:, :-1])
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_backward_cuda(x, conv, windows, d_out.cpu())
    with pytest.raises(TypeError, match="float32"):
        fused.fused_forward_saving_cuda(x.double(), gabor, windows)


def test_train_step_on_card(cuda_device):
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import (TrainState, make_train_step,
                                         optimization_helper)
    cfg = {**CFG, "opt": {"optimizer": "Adam", "lr": 1e-3,
                          "weight_decay": 1e-4, "scheduler": "warmupcosine",
                          "warmup_epochs": 1}}
    model = Classifier(cfg, generator=torch.Generator().manual_seed(0))
    opt, sched, _, _ = optimization_helper(cfg, model.parameters(),
                                           num_tr_steps_per_epoch=2,
                                           num_epochs=4)
    state = TrainState(model, opt, sched)
    step = make_train_step(augment_fn=leaf_device_augment)
    x = next(_operands(4, 16000, 40, cuda_device))
    y = torch.tensor([0, 1, 2, 3], device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    counts = (fused.fused_forward_saving_cuda.launches,
              fused.fused_backward_cuda.launches)
    losses = [float(step(state, x, y, gen)["loss"]) for _ in range(2)]
    assert state.step == 2 and all(np.isfinite(losses))
    assert (fused.fused_forward_saving_cuda.launches,
            fused.fused_backward_cuda.launches) == (counts[0] + 2,
                                                    counts[1] + 2)


def test_leaf_auto_takes_the_kernel(cuda_device):
    x = next(_operands(2, 16000, 40, cuda_device))
    on = Leaf(device=cuda_device)
    off = Leaf(use_fused_kernel="off", device=cuda_device)
    before = fused.fused_forward_cuda.launches
    with torch.no_grad():
        a, b = on(x), off(x)
    assert fused.fused_forward_cuda.launches == before + 1
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_serving_defaults_to_the_card(cuda_device):
    from leaf_tpu_torch.models import Classifier
    state = Classifier(CFG, generator=torch.Generator().manual_seed(0)
                       ).state_dict()
    server = ServingModel(CFG, state_dict=state)
    assert server.device.type == "cuda"
    out = server(np.zeros((3, 16000), np.float32))
    assert out.shape == (3, 35) and np.isfinite(out).all()
