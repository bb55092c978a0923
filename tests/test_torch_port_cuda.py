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
