"""The depthwise-conv op (``leaf_tpu_torch.ops.depthwise``) on the CPU.

The CUDA kernels (``ops/csrc/depthwise.cu``) run only on the card
(tests/test_torch_port_cuda.py holds them against their plain versions
there). Here:

- the plans and the kernels' tiling: ``_emulate_*`` replay each kernel's
  blocks as the source walks them (tiles of planes or bands of rows, the
  staged run with its halo, the coarse positions of the input gradient,
  the weight gradient's channel tiles, batch chunks and stages, the
  partials and their fixed-order sum), in float64 with the plans'
  numbers, and must give F.conv2d's results, write every output once and
  stay inside the shared memory the source sizes from the plan;
- the routing: ``Conv2dSame`` sends exactly the depthwise convs (every
  MBConv's, never the stem's nor a non-depthwise one) to the op, and on
  the CPU the op is today's ``F.pad`` + ``F.conv2d``: the same bits
  forward and backward, in f32 and through the bf16 mode's widening;
- the ops: ``torch.library.opcheck``, the fake implementation's shapes at
  all 12 b0 sites.
"""

import itertools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leaf_tpu_torch.models.common import Conv2dSame
from leaf_tpu_torch.models.efficientnet import EfficientNet
from leaf_tpu_torch.ops import depthwise as dw
from leaf_tpu_torch.scripts.dw_ab import B0_DW_SHAPES

THREADS = 256
SMEM_FLOATS = 12 * 1024  # the source's 48 KB a block
# a small classifier image (filters × frames): b0's strides take it to 2 × 1
IMAGE = (2, 40, 24, 1)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the test runner shares the cores among its
    workers (tests/test_torch_port_export.py's fixture)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _plain(x, w, s):
    """The depthwise conv in float64 through autograd: (y, dx, dw) for a
    cotangent of ones-weighted seeded values."""
    xd = x.double().requires_grad_(True)
    wd = w.double().requires_grad_(True)
    k = w.shape[-1]
    g = dw.geometry(x.shape[2], x.shape[3], k, s)
    y = F.conv2d(F.pad(xd, (g.pl, g.pr, g.pt, g.pb)), wd, stride=s,
                 groups=x.shape[1])
    dy = torch.from_numpy(np.random.RandomState(7).randn(*y.shape))
    dx, dwt = torch.autograd.grad(y, (xd, wd), dy)
    return y.detach().numpy(), dx.numpy(), dwt.numpy(), dy.numpy()


def _ps(rows, wp):
    return rows * wp | 1  # the source's odd plane stride


def _stage_in(src, base, np_, r_lo, r_hi, row0, col0, hs, ws, rows, wp, sm,
              written):
    """stage_in: the run [r_lo ws, (np−1) hs ws + r_hi ws) of the planes
    at ``base`` placed at smem p ps + (r − row0) wp + c + col0."""
    beg, end = r_lo * ws, (np_ - 1) * hs * ws + r_hi * ws
    if end <= beg:
        return
    u = np.arange(beg, end)
    p = u // (hs * ws)
    assert np_ > 1 or (p == 0).all()
    rem = u - p * hs * ws
    r, c = rem // ws, rem % ws
    assert (r - row0 >= 0).all() and (r - row0 < rows).all()
    assert (c + col0 >= 0).all() and (c + col0 < wp).all()
    idx = p * _ps(rows, wp) + (r - row0) * wp + c + col0
    assert idx.max() < len(sm) and not written[idx].any()
    written[idx] = True
    sm[idx] = src[base + u]


def _emulate_forward(x, w, s, sms):
    b, c, h, wd = x.shape
    k = w.shape[-1]
    g = dw.geometry(h, wd, k, s)
    n = b * c
    p_, th = dw.forward_plan(n, h, wd, k, s, sms)
    n_th = -(-g.oh // th)
    assert THREADS % p_ == 0 and (p_ == 1 or n_th == 1)
    wp, rows = wd + g.pl + g.pr, (th - 1) * s + k
    in_floats = (p_ * _ps(rows, wp) + 3) // 4 * 4
    assert in_floats + p_ * th * g.ow <= SMEM_FLOATS
    xf, wf = x.reshape(-1), w.reshape(c, k * k)
    y = np.full(n * g.oh * g.ow, np.nan)
    for blk in range(-(-n // p_) * n_th):
        group, t = divmod(blk, n_th)
        n0 = group * p_
        np_ = min(p_, n - n0)
        oh0 = t * th
        nrow = min(th, g.oh - oh0)
        row0 = oh0 * s - g.pt
        sx = np.zeros(in_floats)
        _stage_in(xf, n0 * h * wd, np_, max(row0, 0),
                  min(row0 + (nrow - 1) * s + k, h), row0, g.pl, h, wd, rows,
                  wp, sx, np.zeros(in_floats, bool))
        sy = np.empty(np_ * nrow * g.ow)
        j = np.arange(nrow * g.ow)
        oh, ow = j // g.ow, j % g.ow
        for p in range(np_):
            taps = wf[(n0 + p) % c]
            base = p * _ps(rows, wp) + oh * s * wp + ow * s
            sy[p * nrow * g.ow + j] = sum(
                taps[i * k + jj] * sx[base + i * wp + jj]
                for i in range(k) for jj in range(k))
        out = slice(n0 * g.oh * g.ow + oh0 * g.ow,
                    n0 * g.oh * g.ow + oh0 * g.ow + len(sy))
        assert np.isnan(y[out]).all()  # each output written once
        y[out] = sy
    return y.reshape(b, c, g.oh, g.ow)


def _emulate_dgrad(dy, w, h, wd, s, sms):
    b, c, oh_, ow_ = dy.shape
    k = w.shape[-1]
    g = dw.geometry(h, wd, k, s)
    n = b * c
    p_, ta = dw.dgrad_plan(n, h, wd, k, s, sms)
    m = -(-k // s)
    a_lo, b_lo = g.pt // s, g.pl // s
    n_a = (h - 1 + g.pt) // s - a_lo + 1
    n_b = (wd - 1 + g.pl) // s - b_lo + 1
    n_ta = -(-n_a // ta)
    # the source's own checks
    assert THREADS % p_ == 0 and (p_ == 1 or n_ta == 1)
    assert a_lo - m + 1 <= 0 and b_lo - m + 1 <= 0
    assert a_lo + n_a >= oh_ and b_lo + n_b >= ow_
    rows, wp = ta + m - 1, n_b + m - 1
    in_floats = (p_ * _ps(rows, wp) + 3) // 4 * 4
    assert in_floats + p_ * min(ta * s, h) * wd <= SMEM_FLOATS
    df, wf = dy.reshape(-1), w.reshape(c, k * k)
    dx = np.full(n * h * wd, np.nan)
    for blk in range(-(-n // p_) * n_ta):
        group, t = divmod(blk, n_ta)
        n0 = group * p_
        np_ = min(p_, n - n0)
        a0 = a_lo + t * ta
        na = min(ta, a_lo + n_a - a0)
        row0 = a0 - (m - 1)
        dx_lo, dx_hi = max(a0 * s - g.pt, 0), min((a0 + na) * s - g.pt, h)
        sd = np.zeros(in_floats)
        _stage_in(df, n0 * oh_ * ow_, np_, max(row0, 0), min(a0 + na, oh_),
                  row0, m - 1 - b_lo, oh_, ow_, rows, wp, sd,
                  np.zeros(in_floats, bool))
        n_rows = dx_hi - dx_lo
        sx = np.full(np_ * n_rows * wd, np.nan)
        j = np.arange(na * n_b)
        ar, bc = j // n_b, j % n_b
        for p in range(np_):
            taps = wf[(n0 + p) % c]
            base = p * _ps(rows, wp) + (ar + m - 1) * wp + bc + m - 1
            for rh in range(s):
                for rw in range(s):
                    acc = sum(taps[(s * mm + rh) * k + s * nn + rw]
                              * sd[base - mm * wp - nn]
                              for mm in range(m) for nn in range(m)
                              if s * mm + rh < k and s * nn + rw < k)
                    ih = (a0 + ar) * s + rh - g.pt
                    iw = (b_lo + bc) * s + rw - g.pl
                    ok = (ih >= dx_lo) & (ih < dx_hi) & (iw >= 0) & (iw < wd)
                    idx = p * n_rows * wd + (ih - dx_lo) * wd + iw
                    assert np.isnan(sx[idx[ok]]).all()
                    sx[idx[ok]] = np.broadcast_to(acc, ok.shape)[ok]
        assert not np.isnan(sx).any()  # every dx pixel of the tile
        out = slice(n0 * h * wd + dx_lo * wd, n0 * h * wd + dx_lo * wd + len(sx))
        assert np.isnan(dx[out]).all()
        dx[out] = sx
    return dx.reshape(b, c, h, wd)


def _emulate_wgrad(x, dy, k, s, sms):
    b, c, h, wd = x.shape
    g = dw.geometry(h, wd, k, s)
    plan = dw.wgrad_plan(b, c, h, wd, k, s, sms)
    ct, tc = plan.ct, THREADS // plan.ct
    n_ct, n_tr = -(-c // ct), -(-g.oh // plan.tr)
    assert THREADS % ct == 0 and (n_tr == 1 or (ct == 1 and plan.bs == 1))
    assert plan.n_chunks == -(-b // plan.chunk)
    wp, rows = wd + g.pl + g.pr, (plan.tr - 1) * s + k
    x_plane, d_plane = _ps(rows, wp), _ps(plan.tr, g.ow)
    x_item, d_item = (ct * x_plane + 3) // 4 * 4, ct * d_plane
    assert plan.bs * (x_item + d_item) <= SMEM_FLOATS
    # the reduction's per-warp sums reuse the x tile
    assert tc <= 32 or (THREADS // 32) * k * k <= plan.bs * x_item
    xf, df = x.reshape(-1), dy.reshape(-1)
    partial = np.full((plan.n_chunks, c, k * k), np.nan)
    for blk in range(n_ct * plan.n_chunks):
        t, ch = blk % n_ct, blk // n_ct
        c0 = t * ct
        nc = min(ct, c - c0)
        acc = np.zeros((nc, k * k))
        b_beg, b_end = ch * plan.chunk, min(b, (ch + 1) * plan.chunk)
        for bb in range(b_beg, b_end, plan.bs):
            nb = min(plan.bs, b_end - bb)
            for tr in range(n_tr):
                oh0 = tr * plan.tr
                nrow = min(plan.tr, g.oh - oh0)
                row0 = oh0 * s - g.pt
                sx = np.zeros(plan.bs * x_item)
                sd = np.zeros(plan.bs * d_item)
                for q in range(nb):
                    n0 = (bb + q) * c + c0
                    _stage_in(xf, n0 * h * wd, nc, max(row0, 0),
                              min(row0 + (nrow - 1) * s + k, h), row0, g.pl,
                              h, wd, rows, wp, sx[q * x_item:(q + 1) * x_item],
                              np.zeros(x_item, bool))
                    _stage_in(df, n0 * g.oh * g.ow, nc, oh0, oh0 + nrow, oh0,
                              0, g.oh, g.ow, plan.tr, g.ow,
                              sd[q * d_item:(q + 1) * d_item],
                              np.zeros(d_item, bool))
                j = np.arange(nrow * g.ow)
                oh, ow = j // g.ow, j % g.ow
                for q in range(nb):
                    for cc in range(nc):
                        d = sd[q * d_item + cc * d_plane + j]
                        base = q * x_item + cc * x_plane + oh * s * wp + ow * s
                        for i in range(k):
                            for jj in range(k):
                                acc[cc, i * k + jj] += (
                                    d * sx[base + i * wp + jj]).sum()
        assert np.isnan(partial[ch, c0:c0 + nc]).all()
        partial[ch, c0:c0 + nc] = acc
    assert not np.isnan(partial).any()
    return partial.sum(0).reshape(c, 1, k, k)  # in chunk order


def _operands(b, c, h, w, k, s, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, c, h, w), rng.randn(c, 1, k, k))


# (B, C, H, W, k, s, SMs): b0's site geometries at a small batch (the SM
# count sets the planes a tile: 1 SM lets tiles grow to their target),
# odd and even planes, and planes past the tile target (banded)
EMULATED = [
    (2, 3, 50, 20, 3, 1, 1), (2, 3, 50, 20, 3, 2, 1), (3, 2, 25, 10, 5, 2, 1),
    (2, 4, 13, 5, 5, 1, 1), (2, 4, 13, 5, 3, 2, 1), (3, 5, 7, 3, 5, 2, 1),
    (4, 5, 4, 2, 5, 1, 1), (4, 5, 4, 2, 3, 1, 132), (2, 2, 9, 6, 5, 2, 1),
    (1, 2, 130, 70, 3, 1, 1), (1, 2, 130, 70, 5, 2, 1),
    (1, 1, 201, 64, 5, 1, 1), (3, 3, 1, 1, 3, 2, 1), (2, 3, 2, 7, 5, 2, 132),
]


@pytest.mark.parametrize("b,c,h,w,k,s,sms", EMULATED)
def test_kernel_tiling_replays_the_conv(b, c, h, w, k, s, sms):
    x, wt = _operands(b, c, h, w, k, s)
    y, dx, dwt, dy = _plain(torch.from_numpy(x), torch.from_numpy(wt), s)
    np.testing.assert_allclose(_emulate_forward(x, wt, s, sms), y,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_emulate_dgrad(dy, wt, h, w, s, sms), dx,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_emulate_wgrad(x, dy, k, s, sms), dwt,
                               rtol=1e-10, atol=1e-10)


def test_banded_plans_cover_audioset_planes():
    # AudioSet's 5 s clips: b0's stem output 32 x 250 (64 filters x 500
    # frames, the stem's stride 2) and its stride-2 site, and both
    # transposed, past the tile target: bands of rows, one plane a block
    for (h, w), c, s in itertools.product(((32, 250), (250, 32)),
                                          (32, 96), (1, 2)):
        p, th = dw.forward_plan(256 * c, h, w, 3, s, 132)
        assert p == 1 and th < dw.geometry(h, w, 3, s).oh
        p, ta = dw.dgrad_plan(256 * c, h, w, 3, s, 132)
        assert p == 1
        plan = dw.wgrad_plan(256, c, h, w, 3, s, 132)
        assert plan.ct == 1 and plan.bs == 1
        assert plan.tr < dw.geometry(h, w, 3, s).oh


@pytest.mark.parametrize("shape", B0_DW_SHAPES,
                         ids=[str(s[:5]) for s in B0_DW_SHAPES])
def test_b0_plans_fill_the_card(shape):
    """At B = 256 on 132 SMs the forward and the input gradient have at
    least four blocks an SM, the weight gradient one wave of the three
    blocks an SM its registers allow (at least 80 % full), each tile
    within 48 KB (the emulated cases check that directly); the weight
    gradient's partials stay below a tenth of the bytes it reads."""
    h, w, c, k, s, _ = shape
    g = dw.geometry(h, w, k, s)
    p, th = dw.forward_plan(256 * c, h, w, k, s, 132)
    assert -(-256 * c // p) * -(-g.oh // th) >= 4 * 132
    p, ta = dw.dgrad_plan(256 * c, h, w, k, s, 132)
    assert -(-256 * c // p) >= 4 * 132
    plan = dw.wgrad_plan(256, c, h, w, k, s, 132)
    assert 0.8 * 3 * 132 <= -(-c // plan.ct) * plan.n_chunks <= 3 * 132
    assert plan.n_chunks * c * k * k * 4 < 0.1 * dw.pass_bytes(256, c, h, w,
                                                               k, s)


def test_pass_bytes_at_b0():
    # 348.8 MB of input planes and 228.0 MB of output planes a pass
    total = sum(dw.pass_bytes(256, c, h, w, k, s) * r
                for h, w, c, k, s, r in B0_DW_SHAPES)
    x_bytes = sum(4 * 256 * c * h * w * r for h, w, c, k, s, r in B0_DW_SHAPES)
    assert round(x_bytes / 1e6, 1) == 348.8
    assert round((total - x_bytes) / 1e6, 1) == 228.0


def test_same_pads_match_conv2d_same():
    for size in range(1, 30):
        for k in (3, 5):
            for s in (1, 2):
                total = max((math.ceil(size / s) - 1) * s + k - size, 0)
                assert dw.same_pads(size, k, s) == (total // 2,
                                                    total - total // 2)


def _b0(dtype=torch.float32):
    return EfficientNet("efficientnet-b0", num_classes=5, compute_dtype=dtype,
                        generator=torch.Generator().manual_seed(0))


def test_routing_takes_every_mbconv_depthwise_and_nothing_else(monkeypatch):
    model = _b0().eval()
    seen = []
    real = dw.depthwise_conv2d_same
    monkeypatch.setattr(dw, "depthwise_conv2d_same",
                        lambda x, w, s: seen.append((x.shape[1:], s))
                        or real(x, w, s))
    convs = [m for m in model.modules() if isinstance(m, Conv2dSame)]
    with torch.no_grad():
        model(torch.randn(*IMAGE))
    blocks = model._blocks
    assert len(seen) == len(blocks) == 16
    assert [s for _, s in seen] == [b.block_args.stride for b in blocks]
    assert [shape[0] for shape, _ in seen] == [
        b._depthwise_conv.in_channels for b in blocks]
    # the stem is the one Conv2dSame that is not a block's depthwise conv
    assert len(convs) == 17 and convs[0] is model._conv_stem
    assert not dw.routes(torch.zeros(1, 1, 8, 8), model._conv_stem.weight,
                         model._conv_stem.stride, model._conv_stem.dilation,
                         model._conv_stem.groups, None)


@pytest.mark.parametrize("case", ["grouped", "dilated", "bias", "float64",
                                  "k7", "stride3", "full"])
def test_routing_leaves_other_convs(case):
    c = 4
    kw = {"grouped": dict(in_channels=c, out_channels=c, groups=2),
          "dilated": dict(dilation=2), "bias": dict(bias=True),
          "float64": {}, "k7": dict(kernel_size=7),
          "stride3": dict(stride=3),
          "full": dict(in_channels=c, out_channels=2 * c, groups=1)}[case]
    args = dict(in_channels=c, out_channels=c, kernel_size=3, stride=1,
                groups=c, bias=False)
    args.update(kw)
    conv = Conv2dSame(args.pop("in_channels"), args.pop("out_channels"),
                      args.pop("kernel_size"), **args)
    x = torch.randn(2, c, 9, 7)
    if case == "float64":
        conv, x = conv.double(), x.double()
    assert not dw.routes(*conv._operands(x)[:2], conv.stride, conv.dilation,
                         conv.groups, conv._operands(x)[2])
    base = Conv2dSame(c, c, 3, groups=c, bias=False)
    assert dw.routes(x.float(), base.weight, base.stride, base.dilation,
                     base.groups, None)


def _today(conv, x):
    """Conv2dSame's forward before the op: F.pad, then F.conv2d of the
    operands."""
    pads = []
    for size, k, s in zip(reversed(x.shape[-2:]), reversed(conv.kernel_size),
                          reversed(conv.stride)):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads)
    return F.conv2d(*conv._operands(x), conv.stride, 0, conv.dilation,
                    conv.groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", B0_DW_SHAPES,
                         ids=[str(s[:5]) for s in B0_DW_SHAPES])
def test_cpu_takes_todays_path_bit_for_bit(shape, dtype):
    h, w, c, k, s, _ = shape
    conv = Conv2dSame(c, c, k, stride=s, groups=c, bias=False)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, c, h, w, generator=gen).to(dtype)
    dy = torch.randn(2, c, -(-h // s), -(-w // s), generator=gen)
    outs = []
    for fn in (conv.forward, lambda t: _today(conv, t)):
        conv.zero_grad()
        xr = x.clone().requires_grad_(True)
        y = fn(xr)
        y.backward(dy)
        outs.append((y, xr.grad, conv.weight.grad.clone()))
    for got, ref in zip(*outs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got, ref)
    with torch.no_grad():
        assert torch.equal(conv(x), _today(conv, x))


def test_b0_train_step_on_cpu_is_bit_for_bit_today(monkeypatch):
    """A train-mode forward and backward of b0 through the op equals the
    same model with the op routed away (``routes`` False): loss, every
    gradient and every running statistic, to the bit."""
    x = torch.randn(*IMAGE, generator=torch.Generator().manual_seed(1))
    runs = []
    for route in (True, False):
        if not route:
            monkeypatch.setattr(dw, "routes", lambda *a: False)
        model = _b0().train()
        gen = torch.Generator().manual_seed(2)
        loss = model(x, generator=gen).square().mean()
        loss.backward()
        runs.append((loss.detach(),
                     {n: p.grad for n, p in model.named_parameters()},
                     {n: b for n, b in model.named_buffers()}))
    (l0, g0, b0), (l1, g1, b1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(b0[n], b1[n]) for n in b0)


def test_remat_recomputes_through_the_op():
    x = torch.randn(*IMAGE, generator=torch.Generator().manual_seed(4))
    grads = []
    for remat in (False, True):
        model = EfficientNet("efficientnet-b0", num_classes=5,
                             generator=torch.Generator().manual_seed(0),
                             remat=remat, drop_connect_rate=0.0,
                             dropout_rate=0.0).train()
        dw.reset_launch_counts()
        model(x).square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("shape", B0_DW_SHAPES,
                         ids=[str(s[:5]) for s in B0_DW_SHAPES])
def test_fake_gives_the_output_shapes(shape):
    h, w, c, k, s, _ = shape
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(256, c, h, w)
        wt = torch.empty(c, 1, k, k)
        y = dw.depthwise_fwd_op(x, wt, s)
        dy = torch.empty(y.shape)
        dx, dwt = dw.depthwise_bwd_op(x, wt, dy, s, True, True)
        assert dw.depthwise_bwd_op(x, wt, dy, s, False, True)[0] is None
        assert dw.depthwise_bwd_op(x, wt, dy, s, True, False)[1] is None
    assert tuple(y.shape) == (256, c, -(-h // s), -(-w // s))
    assert tuple(dx.shape) == (256, c, h, w)
    assert tuple(dwt.shape) == (c, 1, k, k)


# the forward op, and the backward op for dx and dW, dx alone and dW alone
OP_CASES = {"depthwise_fwd": None, "depthwise_bwd": (True, True),
            "depthwise_dgrad": (True, False), "depthwise_wgrad": (False, True)}


@pytest.mark.parametrize("op", list(OP_CASES))
@pytest.mark.parametrize("k,s", dw.SUPPORTED)
def test_ops_pass_opcheck(op, k, s):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 9, 6).astype(np.float32))
    wt = torch.from_numpy(rng.randn(3, 1, k, k).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 3, -(-9 // s), -(-6 // s))
                          .astype(np.float32))
    if OP_CASES[op] is None:
        torch.library.opcheck(torch.ops.leaf_tpu_torch.depthwise_fwd,
                              (x, wt, s))
    else:
        torch.library.opcheck(torch.ops.leaf_tpu_torch.depthwise_bwd,
                              (x, wt, dy, s, *OP_CASES[op]))


def test_op_computes_only_the_wanted_gradients(monkeypatch):
    # the values are held bit for bit by test_cpu_takes_todays_path_bit_for_bit
    calls = []
    real = dw.depthwise_bwd_op
    monkeypatch.setattr(dw, "depthwise_bwd_op",
                        lambda *a: calls.append(a[4:]) or real(*a))
    x, wt = torch.randn(2, 3, 9, 6), torch.randn(3, 1, 5, 5)
    for need_x, need_w in ((True, True), (True, False), (False, True)):
        calls.clear()
        xr = x.clone().requires_grad_(need_x)
        wr = wt.clone().requires_grad_(need_w)
        dw.depthwise_conv2d_same(xr, wr, 2).sum().backward()
        assert calls == [(need_x, need_w)]
        assert (xr.grad is not None) == need_x
        assert (wr.grad is not None) == need_w
    with torch.no_grad():  # no autograd record without a gradient
        assert dw.depthwise_conv2d_same(x.requires_grad_(True), wt,
                                        2).grad_fn is None


def test_cuda_wrappers_refuse_cpu_tensors():
    x, wt = torch.zeros(1, 2, 5, 5), torch.zeros(2, 1, 3, 3)
    before = dw.launch_counts()
    for fn, args in ((dw.depthwise_forward_cuda, (x, wt, 1)),
                     (dw.depthwise_dgrad_cuda, (x, wt, x, 1)),
                     (dw.depthwise_wgrad_cuda, (x, wt, x, 1))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    assert dw.launch_counts() == before
