"""The port's measurement tools (``leaf_tpu_torch.scripts``) on the CPU.

Each tool's ``main`` runs in this process at a tiny size with ``--device
cpu`` (CIFAR-ResNet-20 or the 40-filter Leaf, short clips, B ≤ 4): it
prints one JSON line (the streaming tool one per streamer) with the JAX
script's keys for its quantities, the card fields (``"device": "cpu"``,
no power limit) and ``null`` for every device metric (a CPU time is
never written under a device metric's name). Without a card and without
``--device cpu`` each exits non-zero.

``_measure``: ``frontend_work`` + ``bound`` give the bounds PERF.md's
kernel table states (to 1e-4 ms); ``categorize`` assigns each category
from a fixed list of kernel names. ``dw_ab``'s shift-multiply equals the
grouped conv2d at every b0 depthwise site (forward, dx and dw, B=2, f32,
within 1e-5 of each tensor's largest entry). ``e2e_gap``'s loader gives
the same batches with ``in_memory`` on and off.
"""

import json

import numpy as np
import pytest
import torch

from leaf_tpu_torch.scripts import (_measure, dw_ab, dw_layout_ab, e2e_gap,
                                    kernel_microbench, kernel_profile,
                                    scan_ab, scan_profile, serving_latency,
                                    step_profile, streaming_latency)

CIFAR = ["--arch", "cifar_resnet:20"]
# tool → (its module, CPU arguments, the JAX script's keys, the device
# fields that must be null)
TOOLS = {
    "kernel_microbench": (
        kernel_microbench, ["--batch", "2", "--clip_seconds", "0.25",
                            "--iters", "1", "--plain"],
        ["op_fwd_f32", "op_fwdbwd_f32", "op_fwd_bf16", "op_fwdbwd_bf16",
         "leaf_fwd_f32", "leaf_fwdbwd_f32", "leaf_fwd_bf16",
         "leaf_fwdbwd_bf16", "kernels"],
        lambda r: [r[k]["ms"] for k in r if k.startswith(("op_", "leaf_"))]
        + [v[f] for v in r["kernels"].values()
           for f in ("ms", "share", "library_ms", "plain_ms")]),
    "kernel_profile": (
        kernel_profile, ["--batch", "2", "--clip_seconds", "0.25",
                         "--execs", "1"],
        ["device_busy_ms", "rows"],
        lambda r: [r["device_busy_ms"], r["idle_share"],
                   r["frontend_kernel_ms"]]),
    "step_profile": (
        step_profile, CIFAR + ["--batch", "2", "--clip_seconds", "0.25",
                               "--steps", "1", "--top", "3"],
        ["step_busy_ms", "frontend_fwdbwd_busy_ms", "inference_busy_ms",
         "step_wall_ms"],
        lambda r: [r["step_busy_ms"], r["frontend_fwdbwd_busy_ms"],
                   r["inference_busy_ms"], r["step_idle_share"]]),
    "scan_ab": (
        scan_ab, CIFAR + ["--batch", "2", "--ks", "1", "2", "--steps", "2",
                          "--reps", "1"],
        ["ks"],
        lambda r: [v[f] for v in r["ks"].values()
                   for f in ("busy_ms_per_step", "idle_share",
                             "frontend_ms_per_step")]),
    "scan_profile": (
        scan_profile, CIFAR + ["--batch", "2", "--k", "2", "--steps", "2"],
        ["single", "multi", "delta_busy_ms", "kernel_deltas"],
        lambda r: [r["single"]["busy_ms_per_step"],
                   r["multi"]["busy_ms_per_step"], r["delta_busy_ms"]]),
    "serving_latency": (
        serving_latency, CIFAR + ["--buckets", "2", "--wall-reps", "2",
                                  "--trace-execs", "1"],
        ["metric", "batch", "device_busy_ms", "wall_ms_p50", "wall_ms_min",
         "clips_per_sec_busy"],
        lambda r: [r["device_busy_ms"], r["clips_per_sec_busy"],
                   r["idle_share"], r["kernels_per_request"]]),
    "streaming_latency": (
        streaming_latency, ["--chunks", "1600", "--batch", "2",
                            "--wall-reps", "2", "--trace-execs", "1"],
        ["metric", "chunk_samples", "streams", "device_busy_ms",
         "wall_ms_p50", "realtime_factor_busy"],
        lambda r: [r["device_busy_ms"], r["realtime_factor_busy"],
                   r["idle_share"]]),
    "e2e_gap": (
        e2e_gap, CIFAR + ["--clips", "8", "--batch", "4", "--epochs", "1"],
        ["batch", "clips"] + [f"{k}_{w}" for w in ("int16", "float32")
                              for k in ("loader_only_clips_per_sec",
                                        "h2d_ms_per_batch",
                                        "h2d_only_clips_per_sec",
                                        "e2e_sync_clips_per_sec",
                                        "e2e_prefetch_clips_per_sec")]
        + ["step_only_clips_per_sec", "loader_only_clips_per_sec_int16_disk"],
        lambda r: []),
    "dw_ab": (
        dw_ab, ["--batch", "2", "--iters", "1"], ["f32", "bf16"],
        lambda r: [v for d in ("f32", "bf16") for row in r[d]["shapes"]
                   for k, v in row.items() if k.endswith(("fwd", "fwdbwd"))]
        + list(r["f32"]["total"].values())),
    "dw_layout_ab": (
        dw_layout_ab, ["--batch", "2", "--iters", "1"], ["f32", "bf16"],
        lambda r: [v for d in ("f32", "bf16") for row in r[d]["shapes"]
                   for k in dw_layout_ab.COLS for v in (row[k],)]
        + list(r["bf16"]["total"].values())),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _records(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_prints_its_record_on_the_cpu(name, capsys, tmp_path,
                                           monkeypatch):
    mod, argv, keys, device_fields = TOOLS[name]
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    assert mod.main(argv + ["--device", "cpu"]) == 0
    records = _records(capsys.readouterr().out)
    # one record; the streaming tool's live and exported streamers each
    assert [r.get("mode") for r in records] == (
        ["live", "artifact"] if name == "streaming_latency" else
        [records[0].get("mode")]), records
    for rec in records:
        assert set(keys) <= set(rec), sorted(set(keys) - set(rec))
        assert rec["device"] == "cpu" and rec["power_limit"] is None
        assert rec["count"] == torch.cuda.device_count()
        nulls = device_fields(rec)
        assert all(v is None for v in nulls), nulls


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_without_a_card_exits_non_zero(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    assert TOOLS[name][0].main([]) != 0
    captured = capsys.readouterr()
    assert not _records(captured.out) and "cpu" in captured.err


# PERF.md §6's kernel table: bound ms at B=256, T=16000, F=40 and at the
# AudioSet cfg's B=128, T=80000, F=64 (the primal forward's equals the
# saving forward's: OUT's bytes do not set either bound)
BOUNDS = [
    ((256, 16000, 40), torch.float32, "fwd", 1.6133),
    ((256, 16000, 40), torch.float32, "fwd_save", 1.6133),
    ((256, 16000, 40), torch.float32, "bwd", 1.6351),
    ((256, 16000, 40), torch.bfloat16, "fwd", 0.2853),
    ((256, 16000, 40), torch.bfloat16, "fwd_save", 0.2853),
    ((256, 16000, 40), torch.bfloat16, "bwd", 0.3072),
    ((128, 80000, 64), torch.float32, "fwd", 6.4531),
    ((128, 80000, 64), torch.float32, "bwd", 6.5411),
    ((128, 80000, 64), torch.bfloat16, "fwd", 1.1413),
    ((128, 80000, 64), torch.bfloat16, "bwd", 1.2293),
]


@pytest.mark.parametrize("shape,dtype,kind,want", BOUNDS)
def test_frontend_bounds_match_the_perf_table(shape, dtype, kind, want):
    got = _measure.bound(**_measure.frontend_work(*shape, dtype, kind))
    assert got["bound_by"] == "operations"
    assert abs(got["bound_ms"] - want) < 1e-4, got


def test_frontend_work_counts_each_byte_once():
    b, t, f = 4, 3200, 8
    n_frames = 20
    w = _measure.frontend_work(b, t, f, torch.float32, "fwd_save")
    assert w["nbytes"] == 4 * (b * t + 401 * 2 * f + f * 401
                               + b * n_frames * f + b * 2 * f * t)
    wb = _measure.frontend_work(b, t, f, torch.bfloat16, "bwd")
    assert wb["nbytes"] == (2 * (b * t + b * 2 * f * t + 401 * 2 * f)
                            + 4 * (2 * f * 401 + b * n_frames * f))
    assert wb["tc_flops"] * 3 == _measure.frontend_work(
        b, t, f, torch.float32, "bwd")["tc_flops"]
    with pytest.raises(ValueError, match="kind"):
        _measure.frontend_work(b, t, f, torch.float32, "fused")


def test_categorize_assigns_every_category():
    names = {
        "fused frontend kernels": ["fused_fwd_tf32x3_kernel<true>",
                                   "fused_bwd_bf16_kernel"],
        "NCCL": ["ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs"
                 "StorageV)"],
        "depthwise convolutions": [
            "void at::native::(anonymous namespace)::conv_depthwise2d_"
            "grad_weight_kernel<float, float>(...)"],
        "BatchNorm": ["void at::native::batch_norm_backward_reduce_kernel"
                      "<float>(...)", "void cudnn::bn_fw_tr_1C11_kernel_NCHW"
                      "<float>(...)"],
        "optimizer (foreach Adam)": [
            "void at::native::(anonymous namespace)::multi_tensor_apply_"
            "kernel<at::native::(anonymous namespace)::TensorListMetadata<4>,"
            " FusedAdamMathFunctor>(...)"],
        "cuDNN/cuBLAS convolutions and GEMMs": [
            "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw",
            "nvjet_tst_64x8_64x16_4x1_v_bz_TNT", "void cudnn::engines_"
            "precompiled::nchwToNhwcKernel<float>(...)"],
        "copies/casts": ["Memcpy HtoD (Pageable -> Device)",
                         "void at::native::direct_copy_kernel_cuda(...)",
                         "void at::native::(anonymous namespace)::CatArray"
                         "BatchedCopy<...>(...)"],
        "elementwise/reductions": [
            "void at::native::vectorized_elementwise_kernel<4, ...>(...)",
            "void at::native::reduce_kernel<512, 1, ...>(...)"],
        _measure.OTHER: ["void some_new_kernel<128>(float*)"],
    }
    rows = [(n, 1, 1.0) for ns in names.values() for n in ns]
    got = _measure.categorize(rows)
    assert list(got) == [c for c, _ in _measure.CATEGORIES] + [_measure.OTHER]
    assert got == {c: float(len(ns)) for c, ns in names.items()}, got


@pytest.mark.parametrize("shape", dw_ab.B0_DW_SHAPES,
                         ids=[str(s[:5]) for s in dw_ab.B0_DW_SHAPES])
def test_shift_multiply_equals_grouped_conv(shape):
    x, w, dy = dw_ab.operands(shape, 2, torch.float32, "cpu", seed=3)
    s = shape[4]
    for a, b in zip(dw_ab.grads(dw_ab.dw_conv, x, w, dy, s),
                    dw_ab.grads(dw_ab.dw_shift, x, w, dy, s)):
        # dw sums B·H·W ≤ 2000 products of O(1) terms (|dw| up to ~100):
        # the bound is 1e-5 of each tensor's largest entry
        scale = float(a.detach().abs().max())
        torch.testing.assert_close(b, a, atol=1e-5 * scale, rtol=0)


def test_e2e_loader_same_batches_in_memory_on_and_off(tmp_path):
    e2e_gap.make_dataset(str(tmp_path), 10)
    man, lbl = str(tmp_path / "train.csv"), str(tmp_path / "lbl.json")
    runs = []
    for in_memory in (True, False):
        loader = e2e_gap.build_loader(man, lbl, 4, "int16", in_memory, 2)
        epochs = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            epochs.append([(np.asarray(x).copy(), np.asarray(y).copy())
                           for x, y in loader])
        runs.append(epochs)
    assert len(runs[0][0]) == 2
    for on, off in zip(*runs):
        for (xa, ya), (xb, yb) in zip(on, off):
            assert xa.dtype == xb.dtype == np.int16
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    assert not all(np.array_equal(a[0], b[0])
                   for a, b in zip(runs[0][0], runs[0][1]))
