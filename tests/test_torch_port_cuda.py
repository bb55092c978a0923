"""The port's CUDA kernels on the card: edge shapes and the paths around them.

Every test takes the ``cuda_device`` fixture and skips without a card:
the kernels have no CPU mode (their plain versions are held against the
JAX op in tests/test_torch_port_fused.py). This file imports no JAX, so it runs
on a machine that has only PyTorch; the repository's root conftest.py
imports JAX, hence on the card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

The bf16 kernels' tolerances stand above their tests.

Tolerance, kernel vs plain version (TF32 off): |d| ≤ 1e-4·|ref| +
1e-6·max|ref| for forward values — the kernels sum the 401-tap products
on the tensor cores in 3×TF32 (~22 bits per product), the plain versions
in float32; gradients to 1e-4 of their norm and of their largest entry
(d_bank sums B·T products per entry on the tensor cores in 3×TF32,
~1.5e-5 of the norm at B=256, T=16000).
"""

import csv
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from leaf_tpu_torch.data import loader
from leaf_tpu_torch.data.audio import write_wav
from leaf_tpu_torch.frontend import Leaf
from leaf_tpu_torch.ops import fused_frontend as fused
from leaf_tpu_torch.scripts.dw_ab import B0_DW_SHAPES
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
    # the f32 kernels refuse the bf16 operand set, and the bf16 kernels
    # the f32 one: no quiet cast between them
    with pytest.raises(TypeError, match="_bf16_cuda"):
        fused.fused_forward_cuda(x.bfloat16(), gabor.bfloat16(), windows)
    with pytest.raises(TypeError, match="float32 operands go"):
        fused.fused_forward_bf16_cuda(x, gabor, windows)
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


# ------------------------------------------------------------ bf16 kernels
# Tolerances, bf16 kernel vs its plain bf16 version on the same operands:
# out as the f32 kernels (the bf16 products are exact in f32, only the
# order of the f32 sums differs); OUT within one bf16 ulp of the plain
# OUT (both round f32 sums that may straddle a rounding point) plus
# 1e-6·max|OUT|; d_bank (rounded to bf16 once, at the end) within one
# ulp elementwise and 1e-3 of its norm (measured 1.5e-4 at B=256,
# T=16000); d_windows (f32) as the f32 kernels' gradients.

def _bf16_operands(b, t, f, device, seed=0):
    x, gabor, windows = _operands(b, t, f, device, seed)
    return x.bfloat16(), gabor.bfloat16(), windows


def _bf16_ulp(ref):
    """One bf16 ulp of each entry of ``ref``: 2^(e − 8) for |ref| in
    [2^(e−1), 2^e)."""
    _, e = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def _assert_within_ulp(got, ref, atol_rel):
    got, ref = got.float(), ref.float()
    bound = _bf16_ulp(ref) + atol_rel * ref.abs().max()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= bound).all()), float(
        ((got - ref).abs() / bound).max())


# and the bf16 forward's loop: a block whose chunks store OUT by bulk
# copies (T % 8 == 0) or 2-byte stores (T = 16001, 12345), part-empty
# channel groups (F = 39, 41), one block (B = 1, F <= 20) and 133 blocks
# (one past the 132 SMs of an H100: B = 133, one frame block, F <= 20),
# and a long row (T = 48000); and the bf16 backward's window-major walk:
# a run of kRun = 32 rows cut at the batch end (B = 33), block ranges
# that start mid-run (B = 133 over 132 blocks), accumulator flushes inside
# runs (B = 40, T = 48000: ~450 chunks per block), the unaligned staging
# path (T = 16001), runs of one row (B = 1) and a part-empty channel group
# (F = 41)
BF16_EDGE = [(1, 1, 40), (3, 159, 3), (2, 1000, 20), (3, 1000, 21),
             (2, 3041, 20), (3, 4037, 21), (7, 1000, 40), (2, 16000, 64),
             (3, 12345, 24), (64, 16000, 40), (1, 16000, 20),
             (133, 1000, 20), (2, 16000, 39), (2, 16000, 41),
             (2, 16001, 40), (2, 48000, 40), (33, 1000, 40),
             (133, 1000, 40), (40, 48000, 40), (1, 16000, 40),
             (5, 3041, 41)]


@pytest.mark.parametrize("b,t,f", BF16_EDGE)
def test_bf16_kernels_match_plain(cuda_device, b, t, f):
    x, gabor, windows = _bf16_operands(b, t, f, cuda_device)
    counts = fused.launch_counts()
    got = fused.fused_gabor_sqmod_lowpass(x, gabor, windows)
    out, conv = fused.fused_forward_saving_bf16_cuda(x, gabor, windows)
    torch.cuda.synchronize()
    ref_out, ref_conv = fused.fused_forward_saving_reference(x, gabor, windows)
    _assert_close(got, ref_out)
    _assert_close(out, ref_out)
    assert conv.dtype == torch.bfloat16
    _assert_within_ulp(conv, ref_conv, 1e-6)
    d_out = torch.randn(out.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    d_bank, d_win = fused.fused_backward_bf16_cuda(x, conv, windows, d_out)
    again = fused.fused_backward_bf16_cuda(x, conv, windows, d_out)
    ref_bank, ref_win = fused.fused_backward_reference(x, conv, windows,
                                                       d_out)
    assert d_bank.dtype == torch.bfloat16 and d_win.dtype == torch.float32
    assert torch.equal(d_bank, again[0]) and torch.equal(d_win, again[1])
    _assert_within_ulp(d_bank, ref_bank, 1e-4)
    assert float((d_bank.float() - ref_bank.float()).norm()
                 / ref_bank.float().norm()) <= 1e-3
    _assert_grad_close(d_win, ref_win)
    counts = {k: v - counts[k] for k, v in fused.launch_counts().items()}
    assert counts == {"fwd": 0, "fwd_save": 0, "bwd": 0, "fwd_bf16": 1,
                      "fwd_save_bf16": 1, "bwd_bf16": 2}


def test_bf16_forwards_are_deterministic(cuda_device):
    x, gabor, windows = _bf16_operands(64, 16000, 40, cuda_device)
    assert torch.equal(fused.fused_forward_bf16_cuda(x, gabor, windows),
                       fused.fused_forward_bf16_cuda(x, gabor, windows))
    first = fused.fused_forward_saving_bf16_cuda(x, gabor, windows)
    second = fused.fused_forward_saving_bf16_cuda(x, gabor, windows)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    # OUT bit for bit, signed zeros and all
    assert torch.equal(first[1].view(torch.int16), second[1].view(torch.int16))


def test_bf16_misaligned_waveform(cuda_device):
    # T % 8 == 0, but x starts one bf16 element (2 bytes) past a 16-byte
    # boundary: the kernels take the 2-byte copies
    x, gabor, windows = _bf16_operands(3, 16000, 40, cuda_device)
    flat = torch.empty(x.numel() + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    xs = flat[1:].view_as(x)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 == 2
    ref_out, ref_conv = fused.fused_forward_saving_reference(x, gabor, windows)
    _assert_close(fused.fused_forward_bf16_cuda(xs, gabor, windows), ref_out)
    out, conv = fused.fused_forward_saving_bf16_cuda(xs, gabor, windows)
    _assert_close(out, ref_out)
    _assert_within_ulp(conv, ref_conv, 1e-6)
    d_out = torch.randn(out.shape, device=cuda_device)
    d_bank, d_win = fused.fused_backward_bf16_cuda(xs, conv, windows, d_out)
    ref_bank, ref_win = fused.fused_backward_reference(x, conv, windows,
                                                       d_out)
    _assert_within_ulp(d_bank, ref_bank, 1e-4)
    _assert_grad_close(d_win, ref_win)


def test_bf16_mixed_operands_raise(cuda_device):
    x, gabor, windows = _bf16_operands(2, 16000, 40, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        fused.fused_gabor_sqmod_lowpass(x, gabor.float(), windows)
    with pytest.raises(TypeError, match="bfloat16"):
        fused.fused_forward_bf16_cuda(x, gabor, windows.bfloat16())
    _, conv = fused.fused_forward_saving_bf16_cuda(x, gabor, windows)
    d_out = torch.zeros(2, 100, 40, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        fused.fused_backward_bf16_cuda(x, conv.float(), windows, d_out)


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


def test_train_cli_bf16_launches_the_bf16_kernels(cuda_device, tmp_path):
    root = make_tiny_exp(tmp_path)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run(
        [sys.executable, "-u", "-m", "leaf_tpu_torch.train", "--cfg_file",
         str(root / "cfg.cfg"), "--expdir", str(tmp_path / "exp"),
         "--epochs", "1", "--num_workers", "2", "--bf16"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    m = re.search(r"epoch 0: tr_loss (\S+) .* kernels (\{.*\})", res.stdout)
    assert m and np.isfinite(float(m.group(1))), res.stdout[-2000:]
    # 6 steps, each one bf16 saving forward and one bf16 backward; 2 eval
    # batches, each one bf16 primal forward; no f32 fused launch
    assert json.loads(m.group(2)) == {"fwd": 0, "fwd_save": 0, "bwd": 0,
                                      "fwd_bf16": 2, "fwd_save_bf16": 6,
                                      "bwd_bf16": 6}


def test_synthetic_convergence_runs_the_bf16_kernels(cuda_device, tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run(
        [sys.executable, "-u", "-m", "leaf_tpu_torch.synthetic_convergence",
         "--clips", "70", "--batch", "35", "--epochs", "2", "--root",
         str(tmp_path)], capture_output=True, text=True, timeout=600,
        env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["arch"] == "efficientnet:b0" and 0 <= line["value"] <= 1
    # 70 clips / B=35: 2 steps per epoch, each one bf16 saving forward and
    # one bf16 backward; 35 val clips: one bf16 primal forward per epoch
    assert line["kernels"] == {"fwd": 0, "fwd_save": 0, "bwd": 0,
                               "fwd_bf16": 2, "fwd_save_bf16": 4,
                               "bwd_bf16": 4}


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


# --------------------------------------------------- host pipeline and CLIs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
TEST_SECONDS = (0.4, 1.3, 2.5, 0.7, 1.0, 2.2)   # 1, 2 and 3 windows
CFG_TEXT = """frontend:
    name: leaf
    default_args: False
    n_filters: 8
model:
    arch: efficientnet
    model_depth: b0
    num_classes: 3
    type: multiclass
opt:
    optimizer: Adam
    lr: 1e-3
    weight_decay: 0
    scheduler: warmupcosine
    warmup_epochs: 1
    batch_size: 4
audio_config:
    feature: raw
    normalize: False
    sample_rate: {sr}
    min_duration: 0.25
    random_clip_size: 0.25
    val_clip_size: 0.25
data:
    meta_root: "{root}"
    is_lmdb: False
    train_manifest: train.csv
    val_manifest: val.csv
    test_manifest: None
    label_map: lbl_map.json
"""


def _manifest(path, files, labels):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("files", "labels"))
        w.writerows(zip(files, labels))


def make_tiny_exp(root):
    """A tiny on-disk experiment (after tests/test_preemption.py's): 24
    tone WAVs of 0.4 s in 3 classes, train/val/test manifests (the test
    clips of 1, 2 and 3 one-second windows), a label map, and an
    efficientnet-b0 cfg behind a Leaf of 8 filters with 0.25 s clips and
    B=4. Also used by tests/test_torch_port_cli.py."""
    rng = np.random.RandomState(0)
    files, labels = [], []
    for i in range(24):
        n = int(0.4 * SR)
        x = 0.3 * np.sin(2 * np.pi * (300 + 100 * (i % 3))
                         * np.arange(n) / SR)
        x += 0.01 * rng.randn(n)
        p = str(root / f"c{i}.wav")
        write_wav(p, x.astype(np.float32), SR)
        files.append(p)
        labels.append(f"class{i % 3}")
    _manifest(root / "train.csv", files, labels)
    _manifest(root / "val.csv", files[:6], labels[:6])
    tfiles = []
    for i, sec in enumerate(TEST_SECONDS):
        n = int(sec * SR)
        x = 0.3 * np.sin(2 * np.pi * (300 + 100 * (i % 3))
                         * np.arange(n) / SR) + 0.01 * rng.randn(n)
        p = str(root / f"t{i}.wav")
        write_wav(p, x.astype(np.float32), SR)
        tfiles.append(p)
    _manifest(root / "test.csv", tfiles,
              [f"class{i % 3}" for i in range(len(tfiles))])
    (root / "lbl_map.json").write_text(
        json.dumps({f"class{i}": i for i in range(3)}))
    (root / "cfg.cfg").write_text(CFG_TEXT.format(sr=SR, root=root))
    return root




def _host_batches(n, seed):
    rng = np.random.RandomState(seed)
    return [((rng.randn(64, 16000) * 3000).astype(np.int16),
             rng.randint(0, 35, 64).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("size", [1, 2])
def test_prefetch_pinned_copies_arrive_intact(cuda_device, size):
    # a long kernel ahead of the copies on the stream: every copy executes
    # after the feeder has pinned (and dropped) later batches, so a pinned
    # block reused before its copy ran would show here
    batches = _host_batches(12, size)
    want = [(x.copy(), y.copy()) for x, y in batches]
    torch.cuda._sleep(200_000_000)
    got = list(loader.prefetch_to_device(
        iter(batches), loader.pinned_placer(cuda_device), size=size))
    assert len(got) == len(want)
    for (x, y), (wx, wy) in zip(got, want):
        assert x.is_cuda and x.dtype == torch.int16 and y.dtype == torch.int64
        assert torch.equal(x.cpu(), torch.from_numpy(wx))
        assert torch.equal(y.cpu(), torch.from_numpy(wy.astype(np.int64)))


def test_prefetch_abandoned_early_frees_the_feeder(cuda_device):
    before = threading.active_count()
    feed = loader.prefetch_to_device(iter(_host_batches(30, 3)),
                                     loader.pinned_placer(cuda_device), size=2)
    next(feed)
    feed.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_train_cli_launches_the_kernels(cuda_device, tmp_path):
    root = make_tiny_exp(tmp_path)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run(
        [sys.executable, "-u", "-m", "leaf_tpu_torch.train", "--cfg_file",
         str(root / "cfg.cfg"), "--expdir", str(tmp_path / "exp"),
         "--epochs", "1", "--num_workers", "2", "--log_steps", "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    m = re.search(r"epoch 0: tr_loss (\S+) .* kernels (\{.*\})", res.stdout)
    assert m and np.isfinite(float(m.group(1))), res.stdout[-2000:]
    # 24 clips / B=4: 6 steps, each one saving forward and one backward;
    # 6 val clips: 2 eval batches, each one primal forward
    assert json.loads(m.group(2)) == {"fwd": 2, "fwd_save": 6, "bwd": 6,
                                      "fwd_bf16": 0, "fwd_save_bf16": 0,
                                      "bwd_bf16": 0}


# ------------------------------------- ops, graphs and artifacts on the card

SMALL = {"frontend": {"name": "leaf", "n_filters": 16},
         "audio_config": {"sample_rate": 16000},
         "model": {"arch": "efficientnet", "model_depth": "b0",
                   "num_classes": 5},
         "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
                 "scheduler": "warmupcosine", "warmup_epochs": 1}}


# AST (models/ast.py) behind the same Leaf: 1 s clips give 100 frames,
# 16 filters one row of 9 patches; d 128 in 2 heads of 64
AST_SMALL = {**SMALL, "audio_config": {"sample_rate": 16000,
                                       "random_clip_size": 1},
             "model": {"arch": "ast", "num_classes": 5, "fstride": 10,
                       "tstride": 10, "embed_dim": 128, "depth": 2,
                       "num_heads": 2, "mlp_ratio": 4}}


@pytest.mark.parametrize("bf16", [False, True])
def test_ops_pass_opcheck_on_card(cuda_device, bf16):
    x, gabor, windows = _operands(2, 3000, 40, cuda_device)
    if bf16:
        x, gabor = x.bfloat16(), gabor.bfloat16()
    torch.library.opcheck(torch.ops.leaf_tpu_torch.fused_fwd,
                          (x, gabor, windows))
    torch.library.opcheck(torch.ops.leaf_tpu_torch.fused_fwd_save,
                          (x, gabor, windows))
    out, conv = fused.fused_fwd_save_op(x, gabor, windows)
    torch.library.opcheck(torch.ops.leaf_tpu_torch.fused_bwd,
                          (x, conv, windows, torch.randn_like(out)))


def _small_state(device, capturable, cfg=SMALL):
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import TrainState, optimization_helper
    model = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(0))
    opt, sched, _, _ = optimization_helper(
        cfg, model.parameters(), num_tr_steps_per_epoch=2, num_epochs=4,
        capturable=capturable)
    return TrainState(model, opt, sched)


def _replay_against_eager(device, bf16, k=3, process_group=None,
                          cfg=SMALL):
    """A replay of a K-step graph (K = 3) and K eager steps from copies of
    the same state and generator state (augment, dropout and drop-connect
    on, B=8; the data-parallel steps with a ``process_group``). Returns
    (the replay's metrics, the eager steps' metrics, the two states, the
    parameters before, the two generators, the eager steps' logits, and a
    function that runs the K eager steps once more from the same state
    and generator state and returns that third state)."""
    import copy

    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.training import make_train_multistep, make_train_step
    if bf16:
        cfg = {**cfg, "frontend": {**cfg["frontend"],
                                   "compute_dtype": "bfloat16"},
               "model": {**cfg["model"], "compute_dtype": "bfloat16"}}
    sfx = "_bf16" if bf16 else ""
    st = _small_state(device, True, cfg)
    gen = torch.Generator(device=device).manual_seed(3)
    multi = make_train_multistep(k, augment_fn=leaf_device_augment,
                                 process_group=process_group)
    rng = np.random.RandomState(3)
    groups = [(torch.from_numpy((rng.randn(k, 8, 16000) * 0.1)
                                .astype(np.float32)).to(device),
               torch.from_numpy(rng.randint(0, 5, (k, 8))).to(device))
              for _ in range(2)]
    multi(st, *groups[0], gen)
    assert multi.per_replay == {"fwd_save" + sfx: k, "bwd" + sfx: k}
    p0 = [p.detach().clone() for p in st.model.parameters()]
    blob = (copy.deepcopy(st.model.state_dict()),
            copy.deepcopy(st.optimizer.state_dict()),
            st.scheduler.state_dict(), st.step, gen.get_state())
    step = make_train_step(augment_fn=leaf_device_augment,
                           process_group=process_group)

    def eager_twin():
        twin = _small_state(device, True, cfg)
        twin.model.load_state_dict(blob[0])
        twin.optimizer.load_state_dict(copy.deepcopy(blob[1]))
        twin.scheduler.load_state_dict(blob[2])
        twin.step = blob[3]
        tgen = torch.Generator(device=device)
        tgen.set_state(blob[4])
        return twin, tgen

    twin, tgen = eager_twin()
    before = fused.launch_counts()
    got = multi(st, *groups[1], gen)
    assert fused.launch_counts() == before   # a replay is not counted
    assert multi.replays == 1
    assert multi.graph_launch_counts() == multi.per_replay
    logits = []
    hook = twin.model.register_forward_hook(
        lambda mod, inp, out: logits.append(out.detach().clone()))
    ref = [step(twin, groups[1][0][i], groups[1][1][i], tgen)
           for i in range(k)]
    hook.remove()
    assert st.step == twin.step == 2 * k
    assert st.scheduler.last_epoch == twin.scheduler.last_epoch == 2 * k
    assert int(got["count"]) == 8 * k

    def again():
        third, g3 = eager_twin()
        for i in range(k):
            step(third, groups[1][0][i], groups[1][1][i], g3)
        return third

    return got, ref, st, twin, p0, gen, tgen, logits, again


def _near_ties(logits) -> int:
    """Clips whose top two logits lie within one ulp of the top one in
    the logits' dtype: there the argmax flips with the sums' order."""
    n = 0
    for out in logits:
        top2 = out.float().topk(2, dim=-1).values
        ulp = torch.finfo(out.dtype).eps * top2[:, 0].abs()
        n += int(((top2[:, 0] - top2[:, 1]) <= ulp).sum())
    return n


# the replay's update against the eager steps' update, ‖Δ − Δ_eager‖ /
# ‖Δ_eager‖, is held to max(REPLAY_FLOOR, REPLAY_NOISE_MULT × the same
# measure between two eager runs from the same state in this test): the
# order of cuDNN's sums alone moves this measure, so the noise floor of
# the run decides, with the earlier fixed bound kept as the floor
REPLAY_FLOOR, REPLAY_NOISE_MULT = 3e-2, 2.0


def _update_rel(a, b, p0) -> float:
    num = den = 0.0
    for p, q, r in zip(a.model.parameters(), b.model.parameters(), p0):
        num += float(((p - q) ** 2).sum())
        den += float(((q - r) ** 2).sum())
    assert den > 0
    return (num / den) ** 0.5


@pytest.mark.parametrize("bf16", [False, True])
def test_multistep_graph_matches_eager_steps(cuda_device, bf16):
    # a replay of the K-step graph against K eager steps from copies of
    # the same state and generator state, augment, dropout and
    # drop-connect on. The two are not bit-equal (cuDNN's weight
    # gradients sum in no fixed order), and at B=8 Adam turns gradient
    # entries at float-noise level into lr-sized updates of either sign,
    # so the parameters are held as chip_smoke.py holds two train runs:
    # the update Δ = p − p₀ against the eager one to the bound above; the
    # loss mean to 1e-5 (f32) or three bf16 ulps (measured up to 0.57 by
    # scripts/replay_determinism.py). Under deterministic
    # algorithms the two are bit-equal (the test below), so in bf16 the
    # count of correct clips may differ only by the clips whose top two
    # logits lie within one bf16 ulp, where the argmax flips with the
    # sums' order
    got, ref, st, twin, p0, gen, tgen, logits, again = (
        _replay_against_eager(cuda_device, bf16))
    ref_loss = torch.stack([m["loss"] for m in ref]).float().mean()
    torch.testing.assert_close(got["loss"].float(), ref_loss, atol=0,
                               rtol=3 * 2 ** -7 if bf16 else 1e-5)
    ref_correct = sum(int(m["correct"]) for m in ref)
    ties = _near_ties(logits) if bf16 else 0
    assert abs(int(got["correct"]) - ref_correct) <= ties, (
        int(got["correct"]), ref_correct, ties)
    replay = _update_rel(st, twin, p0)
    noise = _update_rel(again(), twin, p0)
    bound = max(REPLAY_FLOOR, REPLAY_NOISE_MULT * noise)
    print(f"replay vs eager {replay:.4e}, eager vs eager {noise:.4e}, "
          f"bound {bound:.4e}")
    assert replay < bound, (replay, noise)
    assert gen.get_state().equal(tgen.get_state())


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms, and PyTorch's where an op has one
    (warn_only: an op without one runs as it is and warns)."""
    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[:2]
    torch.use_deterministic_algorithms(was[2], warn_only=was[3])
    if was[4] is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = was[4]


@pytest.mark.parametrize("bf16", [False, True])
def test_multistep_graph_bit_equals_eager_when_deterministic(
        cuda_device, deterministic, bf16):
    # with deterministic algorithms a replay runs the eager steps' kernels
    # on the same inputs in the same order: the loss, the counts, every
    # parameter and buffer and the generator state are bit-equal
    got, ref, st, twin, _, gen, tgen, _, _ = _replay_against_eager(
        cuda_device, bf16)
    ref_loss = torch.stack([m["loss"] for m in ref]).float().mean()
    assert torch.equal(got["loss"].float(), ref_loss)
    assert int(got["correct"]) == sum(int(m["correct"]) for m in ref)
    for (name, a), b in zip(st.model.state_dict().items(),
                            twin.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert gen.get_state().equal(tgen.get_state())


def test_multistep_replays_only_its_shape(cuda_device):
    # the train CLI asks can_replay before a replay: a group of another
    # batch shape (a short packed shard) runs as single steps
    from leaf_tpu_torch.training import make_train_multistep
    st = _small_state(cuda_device, True)
    multi = make_train_multistep(2)
    xs = torch.zeros(2, 4, 16000, device=cuda_device)
    ys = torch.zeros(2, 4, dtype=torch.int64, device=cuda_device)
    assert multi.can_replay(xs, ys)
    multi(st, xs, ys)
    assert multi.can_replay(xs, ys)
    assert not multi.can_replay(xs[:, :3], ys[:, :3])
    assert not multi.can_replay(xs.half(), ys)
    with pytest.raises(ValueError, match="batch shape"):
        multi(st, xs[:, :3], ys[:, :3])


def test_multistep_needs_a_capturable_optimizer(cuda_device):
    from leaf_tpu_torch.training import make_train_multistep
    st = _small_state(cuda_device, False)
    xs = torch.zeros(2, 4, 16000, device=cuda_device)
    ys = torch.zeros(2, 4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="capturable=True"):
        make_train_multistep(2)(st, xs, ys)


_MARK = re.compile(r"leaf_tpu_torch(?:::|\d+)(mark_[a-z_]+)")


def _busy_us(rows, lo, hi):
    """Device-busy µs inside [lo, hi] of the (start, end) rows' union."""
    cut = sorted((max(s, lo), min(e, hi)) for s, e in rows
                 if e > lo and s < hi)
    total, reach = 0.0, lo
    for s, e in cut:
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def _marked_replay(frontend):
    """In a fresh process: a K = 4 graph of train steps with the Leaf
    frontend ``frontend`` ('auto': the fused kernels, 'off': the plain
    ops), one replay under the profiler. Prints one JSON line: the
    markers in device order, the replay spans, the device-busy µs, the
    four phases' µs, and whether each load_library call ran inside a
    capture."""
    from torch.autograd import DeviceType

    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.ops import _build
    from leaf_tpu_torch.scripts._measure import profile_window
    from leaf_tpu_torch.training import make_train_multistep
    loads, real = [], _build.load_library
    _build.load_library = lambda: (
        loads.append(torch.cuda.is_current_stream_capturing()), real())[1]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, k = torch.device("cuda"), 4
    cfg = {**SMALL, "frontend": {**SMALL["frontend"],
                                 "use_fused_kernel": frontend}}
    st = _small_state(dev, True, cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    multi = make_train_multistep(k, augment_fn=leaf_device_augment)
    rng = np.random.RandomState(3)
    xs = torch.from_numpy((rng.randn(k, 8, 16000) * 0.1)
                          .astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.randint(0, 5, (k, 8))).to(dev)
    multi(st, xs, ys, gen)           # K eager steps and the capture
    torch.cuda.synchronize()
    prof = profile_window(lambda: multi(st, xs, ys, gen), 1)
    events = prof.events()
    rows = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    marks = sorted((e.time_range.start, e.time_range.end,
                    _MARK.search(e.name).group(1)) for e in rows
                   if _MARK.search(e.name))
    rows = [(e.time_range.start, e.time_range.end) for e in rows]
    at, phases = {}, 0.0
    for s, e, m in marks:
        at[m] = (s, e)
        if m == "mark_update":
            for a, b in (("mark_step", "mark_forward"),
                         ("mark_forward", "mark_frontend"),
                         ("mark_frontend", "mark_backbone_grad"),
                         ("mark_backbone_grad", "mark_backward"),
                         ("mark_backward", "mark_update")):
                phases += _busy_us(rows, at[a][1], at[b][0])
    print(json.dumps({
        "marks": [m for _, _, m in marks],
        "replays": [e.name for e in events
                    if e.device_type == DeviceType.CPU].count(
                        "leaf_tpu_torch.train.replay"),
        "busy": _busy_us(rows, min(s for s, _ in rows),
                         max(e for _, e in rows)),
        "phases": phases, "loads": loads,
        "fused": multi.per_replay.get("fwd_save", 0)}))


@pytest.mark.parametrize("frontend", ["auto", "off"])
def test_multistep_replay_marks_its_phases(cuda_device, frontend):
    # one K = 4 replay under the profiler: four complete sequences of the
    # seven markers in launch order, and the four phases (augment,
    # frontend, backbone, optimizer) hold nearly all of its device time;
    # the markers are built and loaded before the capture, on the plain
    # frontend too (which loads no other kernel). In a fresh process, so
    # that its profiler session is its own (PERF.md §7: on the H100 a
    # process's first profiler session, followed by the data-parallel
    # tests, left a later one-launch window without device rows)
    from leaf_tpu_torch import tracing
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-c", "import tests.test_torch_port_cuda as t; "
         f"t._marked_replay({frontend!r})"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["marks"] == list(tracing.MARKS) * 4
    assert got["replays"] == 1
    assert got["loads"] and not got["loads"][0]
    assert got["fused"] == (4 if frontend == "auto" else 0)
    print(f"{frontend}: phases {got['phases']:.1f} of {got['busy']:.1f} "
          f"device-busy us")
    assert 0.95 * got["busy"] <= got["phases"] <= got["busy"]


def test_ast_matches_the_reference_on_card(cuda_device):
    # AST at a small size (d 192, 2 blocks, 3 heads of 64, 32 filters,
    # 2 s clips: 2 × 19 patches + 2 tokens, B 4) against the benchmark's
    # plain reference (leafbench/reference/ast.py: matmul → softmax →
    # matmul in f32 SGEMMs) on its seeded weights: the logits and the BCE
    # loss's gradient of every parameter. The port's attention is SDPA's
    # f32 kernel and its Leaf the fused kernels, both on the tensor cores
    # in 3×TF32 (≈ 2^-22 a product): logits to 1e-4 of their largest;
    # each gradient to 1e-3 of its largest entry (d_bank sums B·T
    # products, ≈ 1e-5 of its norm in 3×TF32)
    from leaf_tpu_torch.models import Classifier
    from leafbench import inputs
    from leafbench.reference import ast as ref_ast
    from leafbench.reference.classifier import Classifier as RefClassifier
    cfg = {**AST_SMALL, "frontend": {"name": "leaf", "n_filters": 32},
           "audio_config": {"sample_rate": 16000, "random_clip_size": 2},
           "model": {**AST_SMALL["model"], "embed_dim": 192,
                     "num_heads": 3, "num_classes": 527}}
    # the reference reads its image from the model section, as AST's
    # constructor; the port derives it from n_filters and the clip
    ref = RefClassifier({**cfg, "model": {**cfg["model"], "input_fdim": 32,
                                          "input_tdim": 200}},
                        device=cuda_device)
    weights = inputs.make_weights(ref, 21, ref_ast.weight_std)
    port = Classifier(cfg, device=cuda_device)
    port.load_state_dict(weights)
    x = torch.from_numpy(inputs.tone_clips(3, 4, 32000, 16000, "cpu")).to(
        cuda_device)
    y = (torch.rand(4, 527, generator=torch.Generator().manual_seed(0))
         < 0.01).float().to(cuda_device)
    out = []
    for model in (ref, port):
        model.train().zero_grad(set_to_none=True)
        logits = model(x)
        torch.nn.functional.binary_cross_entropy_with_logits(
            logits, y).backward()
        out.append((logits.detach(), {n: p.grad for n, p in
                                      model.named_parameters()}))
    (a, ga), (b, gb) = out
    gap = float((a - b).abs().max() / a.abs().max())
    worst = max((float((g - gb[n]).abs().max() / g.abs().max()), n)
                for n, g in ga.items())
    print(f"AST on card: logit gap {gap:.3e}, worst gradient {worst}")
    assert gap <= 1e-4
    assert worst[0] <= 1e-3, worst


def test_ast_multistep_graph_matches_eager_steps(cuda_device):
    # the K = 4 graph of AST steps (SDPA's kernels captured) replayed
    # against 4 eager steps from copies of the same state and generator
    # state, held as test_multistep_graph_matches_eager_steps holds b0's
    got, ref, st, twin, p0, gen, tgen, _, again = _replay_against_eager(
        cuda_device, False, k=4, cfg=AST_SMALL)
    ref_loss = torch.stack([m["loss"] for m in ref]).mean()
    torch.testing.assert_close(got["loss"], ref_loss, atol=0, rtol=1e-5)
    assert int(got["correct"]) == sum(int(m["correct"]) for m in ref)
    replay = _update_rel(st, twin, p0)
    noise = _update_rel(again(), twin, p0)
    bound = max(REPLAY_FLOOR, REPLAY_NOISE_MULT * noise)
    print(f"AST replay vs eager {replay:.4e}, eager vs eager {noise:.4e}, "
          f"bound {bound:.4e}")
    assert replay < bound, (replay, noise)
    assert gen.get_state().equal(tgen.get_state())


def _ast_marked_replay():
    """In a fresh process: a K = 4 graph of AST train steps (12 blocks),
    one replay under the profiler. Prints one JSON line: the markers in
    device order and the device-busy µs inside the attention cores and
    in all."""
    from torch.autograd import DeviceType

    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.scripts._measure import profile_window
    from leaf_tpu_torch.training import make_train_multistep
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, k = torch.device("cuda"), 4
    cfg = {**AST_SMALL, "model": {**AST_SMALL["model"], "depth": 12}}
    st = _small_state(dev, True, cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    multi = make_train_multistep(k, augment_fn=leaf_device_augment)
    rng = np.random.RandomState(3)
    xs = torch.from_numpy((rng.randn(k, 8, 16000) * 0.1)
                          .astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.randint(0, 5, (k, 8))).to(dev)
    multi(st, xs, ys, gen)           # K eager steps and the capture
    torch.cuda.synchronize()
    prof = profile_window(lambda: multi(st, xs, ys, gen), 1)
    rows = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    marks = sorted((e.time_range.start, e.time_range.end,
                    _MARK.search(e.name).group(1)) for e in rows
                   if _MARK.search(e.name))
    rows = [(e.time_range.start, e.time_range.end) for e in rows]
    at, cores = {}, 0.0
    for s, e, m in marks:
        at[m] = (s, e)
        if m in ("mark_attention_end", "mark_attention_grad_end"):
            opened = at["mark_attention" if m == "mark_attention_end"
                        else "mark_attention_grad"]
            cores += _busy_us(rows, opened[1], s)
    print(json.dumps({
        "marks": [m for _, _, m in marks], "cores": cores,
        "busy": _busy_us(rows, min(s for s, _ in rows),
                         max(e for _, e in rows))}))


def test_ast_replay_marks_its_attention_cores(cuda_device):
    # one K = 4 replay of 12-block AST steps: each step's seven markers
    # with each block's forward core bracketed between mark_frontend and
    # mark_backbone and its backward core (blocks in reverse) between
    # mark_backbone and mark_backbone_grad: 12 × 4 attention markers a
    # step. In a fresh process, as test_multistep_replay_marks_its_phases
    from leaf_tpu_torch import tracing
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-c", "import tests.test_torch_port_cuda as t; "
         "t._ast_marked_replay()"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    fwd, bwd = tracing.ATTENTION_MARKS[:2], tracing.ATTENTION_MARKS[2:]
    m = tracing.MARKS
    step = (list(m[:3]) + list(fwd) * 12 + [m[3]] + list(bwd) * 12
            + list(m[4:]))
    assert got["marks"] == step * 4
    print(f"attention cores {got['cores']:.1f} of {got['busy']:.1f} "
          f"device-busy us")
    assert 0 < got["cores"] < got["busy"]


def test_checkpoint_crosses_capturable_modes(cuda_device, tmp_path):
    from leaf_tpu_torch.training import make_train_step
    from leaf_tpu_torch.training.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    x = next(_operands(4, 16000, 40, cuda_device))
    y = torch.tensor([0, 1, 2, 3], device=cuda_device)
    step = make_train_step()
    for src, dst in ((False, True), (True, False)):
        a = _small_state(cuda_device, src)
        step(a, x, y)
        path = save_checkpoint(str(tmp_path / f"{src}"), a, 0, 0.0, 0.0, 0.0)
        b = _small_state(cuda_device, dst)
        lr = b.optimizer.param_groups[0]["lr"]
        load_checkpoint(path, b)
        group = b.optimizer.param_groups[0]
        assert group["capturable"] is dst and b.step == 1
        if dst:
            assert group["lr"] is lr and lr.is_cuda
        assert float(group["lr"]) == pytest.approx(
            float(a.optimizer.param_groups[0]["lr"]))
        for p in group["params"]:
            assert b.optimizer.state[p]["step"].device.type == (
                "cuda" if dst else "cpu")
        step(b, x, y)
        assert b.step == 2


def test_artifact_runs_the_kernel_on_card(cuda_device, tmp_path):
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.models.common import set_batch_norm_stats_
    from leaf_tpu_torch.serving import save_exported
    model = Classifier(SMALL, generator=torch.Generator().manual_seed(0))
    set_batch_norm_stats_(model.eval(), next(_operands(8, 16000, 40,
                                                       cuda_device)))
    state = model.state_dict()
    manifest = save_exported(str(tmp_path), SMALL, state_dict=state,
                             batch_sizes=(4,))
    assert manifest["device"] == "cuda"
    art = ServingModel.load(str(tmp_path))
    live = ServingModel(SMALL, state_dict=state, batch_sizes=(4,))
    x = (np.random.RandomState(4).randn(6, 16000) * 0.1).astype(np.float32)
    before = fused.fused_forward_cuda.launches
    got = art(x)
    # chunks of 4 and 2 clips at bucket 4: the first runs eagerly (the
    # graph's warm-up, counted by the wrapper), the second replays the
    # graph captured after it (counted by the model)
    assert art.replays == {4: 1}
    assert (fused.fused_forward_cuda.launches - before
            + art.graph_launch_counts()["fwd"]) == 2
    ref = live(x)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        ServingModel.load(str(tmp_path), device="cpu")


def test_streaming_on_card_matches_offline(cuda_device):
    from leaf_tpu_torch.frontend import LeafStreamer
    leaf = Leaf(use_fused_kernel="off", n_filters=16, device=cuda_device)
    wave = (np.random.RandomState(5).randn(3, 8160) * 0.1).astype(np.float32)
    st = LeafStreamer(leaf, 1600)
    frames = [st.process(wave[:, i * 1600:(i + 1) * 1600]) for i in range(5)]
    frames.append(st.flush(wave[:, 8000:]))
    got = torch.cat(frames, dim=1)
    assert got.is_cuda
    with torch.no_grad():
        ref = leaf(torch.from_numpy(wave).to(cuda_device))
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6)


def test_train_cli_steps_per_call_counts_the_replays(cuda_device, tmp_path):
    root = make_tiny_exp(tmp_path)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run(
        [sys.executable, "-u", "-m", "leaf_tpu_torch.train", "--cfg_file",
         str(root / "cfg.cfg"), "--expdir", str(tmp_path / "exp"),
         "--epochs", "2", "--num_workers", "2", "--steps_per_call", "2"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = re.findall(r"epoch (\d): tr_loss (\S+) .* kernels (\{.*\})",
                       res.stdout)
    assert len(lines) == 2 and all(np.isfinite(float(m[1])) for m in lines)
    # 6 steps per epoch as 3 groups of 2: epoch 0 runs the first group
    # eagerly and captures, the other 5 groups replay; 2 eval batches each
    assert json.loads(lines[1][2]) == {"fwd": 4, "fwd_save": 12, "bwd": 12,
                                       "fwd_bf16": 0, "fwd_save_bf16": 0,
                                       "bwd_bf16": 0}


def test_train_cli_watch_flags_on_card(cuda_device, tmp_path):
    # --wandb_watch_model and --watch_histograms on the card (they force
    # --steps_per_call 1); tensorboardX, where installed, gets the
    # histograms, else the logger drops them
    root = make_tiny_exp(tmp_path)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run(
        [sys.executable, "-u", "-m", "leaf_tpu_torch.train", "--cfg_file",
         str(root / "cfg.cfg"), "--expdir", str(tmp_path / "exp"),
         "--epochs", "1", "--num_workers", "2", "--log_steps", "2",
         "--wandb_watch_model", "--watch_histograms",
         "--steps_per_call", "4"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "--steps_per_call forced to 1" in res.stdout
    m = re.search(r"epoch 0: tr_loss (\S+) .* kernels (\{.*\})", res.stdout)
    assert m and np.isfinite(float(m.group(1))), res.stdout[-2000:]
    assert json.loads(m.group(2))["fwd_save"] == 6


# ------------------------------------------------------ data parallelism
# One card: world 1 on NCCL in this process (every collective issued, a
# sum of one term: bit-equal to the plain step under deterministic
# algorithms), world 2 on gloo with both ranks on cuda:0 (spawned by
# tests/torch_parallel_worker.py). tests/test_torch_port_parallel.py holds
# the same steps against the JAX package on the CPU.

@pytest.fixture
def nccl_world1(cuda_device, tmp_path):
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


DP_CFG = {**SMALL, "model": {**SMALL["model"], "dropout_rate": 0.0,
                             "drop_connect_rate": 0.0}}


def _bf16_cfg(cfg):
    return {**cfg, "frontend": {**cfg["frontend"],
                                "compute_dtype": "bfloat16"},
            "model": {**cfg["model"], "compute_dtype": "bfloat16"}}


@pytest.mark.parametrize("bf16", [False, True])
def test_dp_world_of_one_bit_equals_the_plain_step(nccl_world1,
                                                   deterministic, bf16):
    from leaf_tpu_torch.parallel import make_mesh, make_shard_map_train_step
    from leaf_tpu_torch.training import make_train_step
    cfg = _bf16_cfg(DP_CFG) if bf16 else DP_CFG
    x = next(_operands(8, 16000, 40, torch.device("cuda")))
    y = torch.arange(8, device="cuda") % 5
    runs = []
    for step in (make_train_step(), make_train_step(process_group=nccl_world1),
                 make_shard_map_train_step(make_mesh(1))):
        st = _small_state(torch.device("cuda"), False, cfg)
        losses = torch.stack([step(st, x, y)["loss"] for _ in range(2)])
        runs.append((losses, st.model.state_dict()))
    for losses, sd in runs[1:]:
        assert torch.equal(losses, runs[0][0])
        for name, t in sd.items():
            assert torch.equal(t, runs[0][1][name]), name


@pytest.mark.parametrize("bf16", [False, True])
def test_dp_graph_of_four_steps_bit_equals_eager(nccl_world1, deterministic,
                                                 bf16):
    # the K=4 graph captures the data-parallel step's NCCL collectives
    got, ref, st, twin, _, gen, tgen, _, _ = _replay_against_eager(
        torch.device("cuda"), bf16, k=4, process_group=nccl_world1)
    # the mean of the K losses as the graph forms it (in the loss's dtype)
    ref_loss = torch.stack([m["loss"] for m in ref]).mean()
    assert torch.equal(got["loss"], ref_loss)
    assert int(got["correct"]) == sum(int(m["correct"]) for m in ref)
    for (name, a), b in zip(st.model.state_dict().items(),
                            twin.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert gen.get_state().equal(tgen.get_state())


def test_dp_multistep_over_gloo_on_card_raises(cuda_device, tmp_path):
    import torch.distributed as dist

    from leaf_tpu_torch.training import make_train_multistep
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        st = _small_state(cuda_device, True)
        xs = torch.zeros(2, 4, 16000, device=cuda_device)
        ys = torch.zeros(2, 4, dtype=torch.int64, device=cuda_device)
        with pytest.raises(ValueError, match="NCCL"):
            make_train_multistep(2, process_group=dist.group.WORLD)(st, xs,
                                                                    ys)
        assert st.step == 0
    finally:
        dist.destroy_process_group()


def test_dp_world_of_two_on_one_card_matches_the_joined_batch(cuda_device,
                                                              tmp_path):
    # two gloo ranks on cuda:0, each on its half of 16 clips, against the
    # plain step on all 16: loss 2e-4, BN running stats 1e-5 of the
    # layer's scale, the replicas equal, one saving-forward and one
    # backward launch on each rank; per-replica BatchNorm misses the stats
    from leaf_tpu_torch.models.common import BatchNorm2d
    from leaf_tpu_torch.training import make_train_step
    from tests.torch_parallel_worker import run_world
    rng = np.random.RandomState(4)
    x = (rng.randn(16, 16000) * 0.1).astype(np.float32)
    x[8:] *= 3.0
    y = (np.arange(16) % 5).astype(np.int64)
    st = _small_state(cuda_device, False, DP_CFG)
    sd = {k: v.cpu().numpy() for k, v in st.model.state_dict().items()}
    ranks = run_world(tmp_path, {"tasks": ["dp_step"], "cfg": DP_CFG,
                                 "state_dict": sd, "x": x, "y": y,
                                 "device": "cuda:0"})
    m = make_train_step()(st, torch.from_numpy(x).to(cuda_device),
                          torch.from_numpy(y).to(cuda_device))
    ref = {k: v.cpu().numpy() for k, v in st.model.state_dict().items()}

    def stats_err(got):
        worst = 0.0
        for name, mod in st.model.named_modules():
            if isinstance(mod, BatchNorm2d):
                var = ref[name + ".running_var"]
                worst = max(worst, np.abs(got[name + ".running_mean"]
                                          - ref[name + ".running_mean"]).max()
                            / np.sqrt(var).max(),
                            np.abs(got[name + ".running_var"] - var).max()
                            / var.max())
        return worst

    for r in ranks:
        g = r["dp_step"]["global"]
        assert abs(g["metrics"]["loss"] - float(m["loss"])) <= (
            2e-4 * abs(float(m["loss"])))
        assert g["metrics"]["count"] == 16
        assert g["launches"]["fwd_save"] == g["launches"]["bwd"] == 1
        assert stats_err(g["sd"]) < 1e-5
        assert stats_err(r["dp_step"]["per_replica"]["sd"]) > 1e-3
    a, b = (r["dp_step"]["global"]["sd"] for r in ranks)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_dryrun_multichip_on_the_card(cuda_device, capsys):
    # the dry run's default: one NCCL rank per card, here on every card
    # of the machine (the CUDA graph of its K = 2 call captures NCCL)
    from leaf_tpu_torch.dryrun import dryrun_multichip
    n = torch.cuda.device_count()
    line = dryrun_multichip(n)
    assert f"dryrun_multichip({n}): ok" in line
    assert "bit-identical" in capsys.readouterr().out


# the measurement tools chip_smoke.py does not drive, each at a tiny
# iteration count: (tool, arguments, the device fields of its record)
TOOL_RUNS = [
    ("kernel_profile", ["--batch", "16", "--execs", "1", "--top", "5"],
     lambda r: [r["device_busy_ms"], r["frontend_kernel_ms"]]),
    ("scan_profile", ["--batch", "16", "--k", "2", "--steps", "2",
                      "--top", "5"],
     lambda r: [r["single"]["busy_ms_per_step"],
                r["multi"]["busy_ms_per_step"]]),
    ("streaming_latency", ["--chunks", "1600", "--batch", "4",
                           "--wall-reps", "3", "--trace-execs", "1"],
     lambda r: [r["device_busy_ms"], r["realtime_factor_busy"]]),
    ("dw_ab", ["--batch", "16", "--iters", "2"],
     lambda r: [*r["f32"]["total"].values(), *r["bf16"]["total"].values()]),
    ("dw_layout_ab", ["--batch", "16", "--iters", "2"],
     lambda r: [*r["f32"]["total"].values(), *r["bf16"]["total"].values()]),
]


@pytest.mark.parametrize("name,argv,fields", TOOL_RUNS,
                         ids=[t[0] for t in TOOL_RUNS])
def test_measurement_tool_on_card(cuda_device, name, argv, fields, capsys):
    import importlib
    tool = importlib.import_module(f"leaf_tpu_torch.scripts.{name}")
    assert tool.main(argv) == 0
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert records
    for rec in records:
        assert rec["device"] == torch.cuda.get_device_name(0)
        assert rec["power_limit"] and rec["count"] >= 1
        values = fields(rec)
        assert values and all(v is not None and np.isfinite(v) and v > 0
                              for v in values), (name, values)


def test_smoke_leaf_on_card(cuda_device, capsys):
    # the forward smoke runs Leaf()'s fused primal kernel on the card and
    # agrees with the plain version (Leaf 'off') on its waveform
    from leaf_tpu_torch.scripts import smoke_leaf
    before = fused.fused_forward_cuda.launches
    assert smoke_leaf.main([]) == 0
    assert fused.fused_forward_cuda.launches == before + 1
    out = capsys.readouterr().out
    assert "input: (1, 16000)" in out and "output: (1, 100, 40)" in out
    leaf, x, got = smoke_leaf.smoke("cuda")
    off = Leaf(use_fused_kernel="off", device=cuda_device)
    off.load_state_dict(leaf.state_dict())
    with torch.no_grad():
        ref = off(x)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    lo, hi, mean = (float(v) for v in out.split("min/max/mean:")[1].split())
    assert (lo, hi, mean) == (float(got.min()), float(got.max()),
                              float(got.mean()))


# ------------------------------------------------ depthwise conv kernels
# ops/csrc/depthwise.cu against the native grouped conv on the padded x
# (F.conv2d(F.pad(...), groups=C), its autograd for dx and dW), f32, TF32
# off (the native depthwise kernels take no TF32 either). Tolerances: the
# forward and dx sum k² (≤ 25) products per entry in another order than
# the native kernels: 1e-5 of the tensor's largest entry (≈ 80 f32 ulps of
# it); dW sums up to B·OH·OW = 256 000 products per entry (per-thread
# partial sums, a butterfly, the chunks in order): 2e-5 of the largest
# entry (measured ≤ 2.1e-6 against the native one and ≤ 4.9e-7 against a
# float64 sum on the H100; the native one reads ≤ 1.9e-6 there).
DW_TOL, DW_GRAD_TOL = 1e-5, 2e-5
# b0's 12 sites (dw_ab.B0_DW_SHAPES) and AudioSet's 5 s planes (b0's
# stem output at 64 filters x 500 frames, stride 1 and its stride-2 site),
# as the classifier runs them, then each transposed: the other axis takes
# each pad and each plan's tiling
DW_MODEL_SITES = [s[:5] for s in B0_DW_SHAPES] + [(32, 250, 32, 3, 1),
                                                  (32, 250, 96, 3, 2)]
DW_SITES = DW_MODEL_SITES + [(w, h, c, k, s)
                             for h, w, c, k, s in DW_MODEL_SITES]


def _dw_operands(h, w, c, k, s, device, b=256, seed=0):
    from leaf_tpu_torch.ops import depthwise as dw
    rng = np.random.RandomState(seed)
    g = dw.geometry(h, w, k, s)
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32))
    wt = torch.from_numpy((rng.randn(c, 1, k, k) * 0.2).astype(np.float32))
    dy = torch.from_numpy(rng.randn(b, c, g.oh, g.ow).astype(np.float32))
    return x.to(device), wt.to(device), dy.to(device)


def _dw_native(x, wt, dy, s):
    import torch.nn.functional as F

    from leaf_tpu_torch.ops import depthwise as dw
    xr, wr = x.detach().requires_grad_(True), wt.detach().requires_grad_(True)
    g = dw.geometry(x.shape[2], x.shape[3], wt.shape[-1], s)
    y = F.conv2d(F.pad(xr, (g.pl, g.pr, g.pt, g.pb)), wr, stride=s,
                 groups=x.shape[1])
    dx, dwt = torch.autograd.grad(y, (xr, wr), dy)
    return y.detach(), dx, dwt


def _close_to_max(got, ref, tol):
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= tol, err


@pytest.mark.parametrize("site", DW_SITES, ids=[str(s) for s in DW_SITES])
def test_depthwise_kernels_match_native(cuda_device, site):
    from leaf_tpu_torch.ops import depthwise as dw
    h, w, c, k, s = site
    x, wt, dy = _dw_operands(h, w, c, k, s, cuda_device)
    y_ref, dx_ref, dw_ref = _dw_native(x, wt, dy, s)
    before = dw.launch_counts()
    y = dw.depthwise_forward_cuda(x, wt, s)
    dx = dw.depthwise_dgrad_cuda(x, wt, dy, s)
    dwt = dw.depthwise_wgrad_cuda(x, wt, dy, s)
    torch.cuda.synchronize()
    assert dw.launch_counts() == {n: v + 1 for n, v in before.items()}
    _close_to_max(y, y_ref, DW_TOL)
    _close_to_max(dx, dx_ref, DW_TOL)
    _close_to_max(dwt, dw_ref, DW_GRAD_TOL)


def test_depthwise_weight_gradient_is_deterministic(cuda_device):
    from leaf_tpu_torch.ops import depthwise as dw
    for site in ((20, 50, 32, 3, 1), (2, 4, 1152, 5, 1), (32, 250, 96, 3, 2)):
        h, w, c, k, s = site
        x, wt, dy = _dw_operands(h, w, c, k, s, cuda_device, seed=1)
        first = dw.depthwise_wgrad_cuda(x, wt, dy, s)
        assert torch.equal(first, dw.depthwise_wgrad_cuda(x, wt, dy, s))
        assert torch.equal(dw.depthwise_forward_cuda(x, wt, s),
                           dw.depthwise_forward_cuda(x, wt, s))


def test_depthwise_autograd_runs_the_kernels(cuda_device):
    # the conv under autograd goes through the ops, whose CUDA
    # implementations launch the kernels: the wrappers' bits, one launch
    # of each
    from leaf_tpu_torch.ops import depthwise as dw
    x, wt, dy = _dw_operands(10, 25, 144, 5, 2, cuda_device, b=16, seed=2)
    xr, wr = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    before = dw.launch_counts()
    y = dw.depthwise_conv2d_same(xr, wr, 2)
    y.backward(dy)
    assert dw.launch_counts() == {n: v + 1 for n, v in before.items()}
    assert torch.equal(y.detach(), dw.depthwise_forward_cuda(x, wt, 2))
    assert torch.equal(xr.grad, dw.depthwise_dgrad_cuda(x, wt, dy, 2))
    assert torch.equal(wr.grad, dw.depthwise_wgrad_cuda(x, wt, dy, 2))
    with torch.no_grad():
        assert torch.equal(dw.depthwise_conv2d_same(x, wt, 2), y.detach())


def test_depthwise_wrapper_refusals(cuda_device):
    from leaf_tpu_torch.ops import depthwise as dw
    x, wt, dy = _dw_operands(13, 5, 8, 3, 1, cuda_device, b=2)
    with pytest.raises(ValueError, match="contiguous"):
        dw.depthwise_forward_cuda(x.transpose(2, 3), wt, 1)
    with pytest.raises(TypeError, match="float32"):
        dw.depthwise_forward_cuda(x.bfloat16(), wt.bfloat16(), 1)
    with pytest.raises(ValueError, match="CUDA"):
        dw.depthwise_forward_cuda(x, wt.cpu(), 1)
    with pytest.raises(ValueError, match="k, stride"):
        dw.depthwise_forward_cuda(x, wt, 3)
    with pytest.raises(ValueError, match="dy must be"):
        dw.depthwise_dgrad_cuda(x, wt, dy[:, :, :-1].contiguous(), 1)


def test_depthwise_ops_pass_opcheck_on_card(cuda_device):
    from leaf_tpu_torch.ops import depthwise as dw
    for k, s in dw.SUPPORTED:
        x, wt, dy = _dw_operands(9, 6, 3, k, s, cuda_device, b=2)
        torch.library.opcheck(torch.ops.leaf_tpu_torch.depthwise_fwd,
                              (x, wt, s))
        for need in ((True, True), (True, False), (False, True)):
            torch.library.opcheck(torch.ops.leaf_tpu_torch.depthwise_bwd,
                                  (x, wt, dy, s, *need))


DW_SYMBOLS = {"depthwise_fwd": "depthwise_fwd<",
              "depthwise_dgrad": "depthwise_dgrad<",
              "depthwise_wgrad": "depthwise_wgrad<",
              "depthwise_wgrad_sum": "depthwise_wgrad_sum"}


def test_multistep_replay_runs_the_depthwise_kernels(cuda_device):
    # a K = 4 graph of b0 train steps: the K eager steps of the first call
    # launch each depthwise kernel 16 times a step (the capture's launches
    # are not counted, as the fused kernels' are not), and one profiled
    # replay runs 16·K of each and no native conv_depthwise2d kernel
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.ops import depthwise as dw
    from leaf_tpu_torch.scripts._measure import device_profile
    from leaf_tpu_torch.training import make_train_multistep
    k = 4
    st = _small_state(cuda_device, True)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    multi = make_train_multistep(k, augment_fn=leaf_device_augment)
    rng = np.random.RandomState(3)
    xs = torch.from_numpy((rng.randn(k, 8, 16000) * 0.1)
                          .astype(np.float32)).to(cuda_device)
    ys = torch.from_numpy(rng.randint(0, 5, (k, 8))).to(cuda_device)
    dw.reset_launch_counts()
    multi(st, xs, ys, gen)
    torch.cuda.synchronize()
    assert dw.launch_counts() == {n: 16 * k for n in dw.KERNELS}
    prof = device_profile(lambda: multi(st, xs, ys, gen))
    assert dw.launch_counts() == {n: 16 * k for n in dw.KERNELS}
    seen = {n: prof.count(sym) for n, sym in DW_SYMBOLS.items()}
    assert seen == {n: 16 * k for n in DW_SYMBOLS}, seen
    assert prof.count("conv_depthwise2d") == 0
    assert not [r for r in prof.rows if "depthwise" in r[0].lower()
                and "leaf_tpu_torch" not in r[0]]


def test_artifact_runs_the_depthwise_kernels_on_card(cuda_device, tmp_path):
    # torch.export records the op through its fake implementation; the
    # loaded program launches the forward kernel at each of b0's 16 sites
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.ops import depthwise as dw
    from leaf_tpu_torch.serving import save_exported
    model = Classifier(SMALL, generator=torch.Generator().manual_seed(0))
    manifest = save_exported(str(tmp_path), SMALL,
                             state_dict=model.state_dict(), batch_sizes=(4,))
    program = torch.export.load(str(tmp_path / manifest["files"]["4"]))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("leaf_tpu_torch.depthwise_fwd.default") == 16
    art = ServingModel.load(str(tmp_path))
    before = dw.depthwise_forward_cuda.launches
    art((np.random.RandomState(4).randn(4, 16000) * 0.1).astype(np.float32))
    assert dw.depthwise_forward_cuda.launches == before + 16


# ---------------------------------------------- ServingModel's CUDA graphs

GRAPH_BUCKETS = (8, 64, 256)


@pytest.fixture(scope="module")
def graph_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are CUDA graphs")
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.models.common import set_batch_norm_stats_
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Classifier(SMALL, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        set_batch_norm_stats_(model.eval(), next(_operands(
            64, 16000, 40, torch.device("cuda"), seed=7)))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def graph_artifact(graph_weights, tmp_path_factory):
    from leaf_tpu_torch.serving import save_exported
    out = tmp_path_factory.mktemp("graph_artifact")
    save_exported(str(out), SMALL, state_dict=graph_weights,
                  batch_sizes=GRAPH_BUCKETS)
    return str(out)


def _graph_server(kind, weights, artifact):
    if kind == "live":
        return ServingModel(SMALL, state_dict=weights,
                            batch_sizes=GRAPH_BUCKETS)
    return ServingModel.load(artifact)


def _clips(n, seed):
    return (np.random.RandomState(seed).randn(n, 16000) * 0.1
            ).astype(np.float32)


def _eager(server, x):
    """Each chunk of ``x`` through the server's module or program, called
    eagerly at its bucket: the answer without a graph."""
    outs = []
    with torch.inference_mode():
        for start in range(0, len(x), GRAPH_BUCKETS[-1]):
            chunk = torch.from_numpy(x[start:start + GRAPH_BUCKETS[-1]])
            take = chunk.shape[0]
            b = server._bucket(take)
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, b - take))
            outs.append(server._forward[b](chunk.to(server.device))[:take]
                        .cpu().numpy())
    return np.concatenate(outs)


def _same(got, ref):
    # bit for bit where the same kernels run, else 1e-6 of max|logit|
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), float(
        np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("kind", ["live", "loaded"])
def test_serving_graph_replays_the_eager_forward(graph_weights,
                                                 graph_artifact, kind):
    from leaf_tpu_torch.ops import depthwise as dw
    server = _graph_server(kind, graph_weights, graph_artifact)
    fwd, dwf = fused.fused_forward_cuda.launches, \
        dw.depthwise_forward_cuda.launches
    got = {}
    for b in GRAPH_BUCKETS:
        x, y = _clips(b, seed=b), _clips(b, seed=b + 1)
        got[b] = (server(x), server(x), server(y))  # warm-up, replay, replay
    # the wrappers counted each bucket's warm-up only; the replays are
    # counted by the model, one primal launch and b0's 16 depthwise sites
    assert fused.fused_forward_cuda.launches - fwd == len(GRAPH_BUCKETS)
    assert dw.depthwise_forward_cuda.launches - dwf == 16 * len(
        GRAPH_BUCKETS)
    assert server.replays == {b: 2 for b in GRAPH_BUCKETS}
    assert server.per_replay == {b: {"fwd": 1, "depthwise_fwd": 16}
                                 for b in GRAPH_BUCKETS}
    assert server.graph_launch_counts() == {
        "fwd": 2 * len(GRAPH_BUCKETS),
        "depthwise_fwd": 32 * len(GRAPH_BUCKETS)}
    assert server.pool_bytes > 0
    for b in GRAPH_BUCKETS:
        ref_x = _eager(server, _clips(b, seed=b))
        ref_y = _eager(server, _clips(b, seed=b + 1))
        warm, again, other = got[b]
        _same(warm, ref_x)
        _same(again, ref_x)
        _same(other, ref_y)
        assert not np.allclose(other, again)


@pytest.mark.parametrize("kind", ["live", "loaded"])
def test_serving_graph_chunks_a_large_request(graph_weights, graph_artifact,
                                              kind):
    # 300 clips: a chunk of 256, then 44 padded to the 64 bucket
    server = _graph_server(kind, graph_weights, graph_artifact)
    x = _clips(300, seed=300)
    first, again = server(x), server(x)
    assert server.replays == {64: 1, 256: 1}
    ref = _eager(server, x)
    _same(first, ref)
    _same(again, ref)


@pytest.mark.parametrize("kind", ["live", "loaded"])
def test_serving_graph_sees_in_place_batch_norm_updates(
        graph_weights, graph_artifact, kind):
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.models.common import set_batch_norm_stats_
    server = _graph_server(kind, graph_weights, graph_artifact)
    x = _clips(64, seed=64)
    server(x)
    before = server(x)                       # a replay
    other = Classifier(SMALL).eval()
    other.load_state_dict(graph_weights)
    with torch.no_grad():
        set_batch_norm_stats_(other, next(_operands(
            64, 16000, 40, torch.device("cuda"), seed=8)))
    stats = {k: v for k, v in other.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    for module in ({server.model} if kind == "live"
                   else set(server._forward.values())):
        bufs = dict(module.named_buffers())
        assert set(stats) <= set(bufs)
        with torch.no_grad():
            for k, v in stats.items():
                bufs[k].copy_(v)
    after = server(x)                        # a replay on the new stats
    assert server.replays == {64: 2}
    ref = _eager(server, x)
    _same(after, ref)
    assert np.abs(after - before).max() > 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["live", "loaded"])
def test_serving_graph_threads_get_their_own_logits(graph_weights,
                                                    graph_artifact, kind):
    server = _graph_server(kind, graph_weights, graph_artifact)
    # one caller's requests at buckets 8 and 64, the other's at 64 and 300
    # clips (256 + 64): both race on the first captures and then share the
    # 64 bucket's buffers
    requests = [[_clips(8, 11), _clips(64, 12)],
                [_clips(64, 13), _clips(300, 14)]]
    want = [[_eager(server, x) for x in reqs] for reqs in requests]
    got, errors = [[], []], []

    def caller(i):
        try:
            for j in range(12):
                got[i].append((j % 2, server(requests[i][j % 2])))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    for i in (0, 1):
        assert len(got[i]) == 12
        for j, out in got[i]:
            _same(out, want[i][j])
    assert server.replays == {8: 5, 64: 17, 256: 5}
