"""The port's CLIs, ``python -m leaf_tpu_torch.train`` and
``python -m leaf_tpu_torch.evaluate``, on the CPU (``--device cpu``), and
its loggers.

A tiny on-disk experiment after tests/test_preemption.py's
``make_tiny_exp`` (24 tone WAVs of 0.4 s, 3 classes, 0.25 s clips, B=4),
with an efficientnet-b0 backbone behind a small Leaf (8 filters), and
once with a ResNet-18 (trained, evaluated and exported). The CLIs behave
as the JAX
CLIs do: SIGTERM mid-epoch → ``epoch_000_preempt`` with meta epoch −1 →
resume at epoch 0; ``--bn_recalibrate`` before validation; evaluate
writes ``results.txt`` in the JAX format and skips when it is there.

The scoring is held against the JAX package: weights carried from JAX
by ``load_jax_variables`` (BN stats set from the test windows, so the
logits are O(1)), the port's evaluate gives the same per-clip predictions and
accuracy as the JAX ``Classifier.apply`` over the same 1 s windows (mean
logits to 1e-4 of their scale, float32 torch vs XLA).
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.data import RawWaveformDataset as JaxDataset
from leaf_tpu.data.transforms import Compose as JaxCompose
from leaf_tpu.data.transforms import PeakNormalization as JaxPeak
from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu_torch import evaluate
from leaf_tpu_torch.models import Classifier, load_jax_variables
from leaf_tpu_torch.models.common import set_batch_norm_stats_
from leaf_tpu_torch.training import TrainState
from leaf_tpu_torch.training.checkpoint import (latest_checkpoint,
                                                save_checkpoint, save_hparams)
from leaf_tpu_torch.training.loggers import (RateTracker, TrainLogger,
                                             profile_trace)
from tests.test_torch_port_cuda import TEST_SECONDS, make_tiny_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
# The test runner shares the cores among its workers; a CLI process with
# PyTorch's default of one intra-op thread per core oversubscribes them,
# and its many small ops then wait on each other's threads.
THREADS = 2


def _env():
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "OMP_NUM_THREADS": str(THREADS)}
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture
def few_threads():
    """The in-process CLI runs on THREADS intra-op threads, as the
    subprocesses do."""
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _train_args(root, expdir, epochs, extra=()):
    return [sys.executable, "-u", "-m", "leaf_tpu_torch.train",
            "--cfg_file", str(root / "cfg.cfg"), "--expdir", str(expdir),
            "--epochs", str(epochs), "--num_workers", "1", "--log_steps", "1",
            "--device", "cpu", *extra]


def _eval_args(root, expdir, extra=()):
    return ["--exp_dir", str(expdir), "--meta_dir", str(root),
            "--test_csv_name", "test.csv", "--device", "cpu", *extra]


def test_sigterm_checkpoints_and_resumes(tmp_path):
    root = make_tiny_exp(tmp_path)
    expdir = tmp_path / "exp"
    proc = subprocess.Popen(_train_args(root, expdir, 50),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=_env(), cwd=REPO)
    lines, stepped = [], 0
    deadline = time.time() + 300
    for line in proc.stdout:
        lines.append(line)
        if " step " in line and "rate" in line:
            stepped += 1
            if stepped >= 2:
                proc.send_signal(signal.SIGTERM)
                break
        assert time.time() < deadline, "".join(lines[-20:])
    rest, _ = proc.communicate(timeout=300)
    out = "".join(lines) + (rest or "")
    assert proc.returncode == 0, out[-3000:]
    assert "SIGTERM: checkpointed mid-epoch 0" in out, out[-3000:]
    assert os.listdir(expdir / "epoch_000_preempt") and not os.path.exists(
        expdir / "epoch_000")
    meta = json.loads((expdir / "epoch_000_preempt" / "meta.json").read_text())
    assert meta["epoch"] == -1 and meta["val_acc"] == -1.0
    assert latest_checkpoint(str(expdir)).endswith("epoch_000_preempt")
    # the rewound schedule clock: step 0 of the redone epoch
    blob = torch.load(expdir / "epoch_000_preempt" / "state.pt",
                      weights_only=True)
    assert blob["step"] == 0 and blob["scheduler"]["last_epoch"] == 0

    res = subprocess.run(_train_args(root, expdir, 1,
                                     ("--continue_from_ckpt", "latest")),
                         capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-2000:]
    assert re.search(r"resumed from \S+_preempt at epoch 0", res.stdout), \
        res.stdout[-2000:]
    assert "epoch 0: tr_loss" in res.stdout and "done." in res.stdout
    assert os.path.exists(expdir / "epoch_000" / "state.pt")


@pytest.fixture(scope="module")
def trained_exp(tmp_path_factory):
    """One epoch with --bn_recalibrate 8 (more than the 6-step epoch: the
    loader cycles), through the CLI."""
    root = make_tiny_exp(tmp_path_factory.mktemp("tiny"))
    expdir = root / "exp"
    res = subprocess.run(_train_args(root, expdir, 1,
                                     ("--bn_recalibrate", "8")),
                         capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-2000:]
    return root, expdir, res.stdout


def test_bn_recalibrate_runs_before_validation(trained_exp):
    _, expdir, out = trained_exp
    recal = out.find("recalibrated BN stats on 8 train batches")
    epoch_line = re.search(r"epoch 0: tr_loss (\S+) .* val_acc (\S+) .*"
                           r"kernels (\{.*\})", out)
    assert recal >= 0 and epoch_line and recal < epoch_line.start(), out
    assert np.isfinite(float(epoch_line.group(1)))
    assert 0.0 <= float(epoch_line.group(2)) <= 1.0
    # the CPU runs the kernels' plain versions: no kernel launched
    assert json.loads(epoch_line.group(3)) == {
        "fwd": 0, "fwd_save": 0, "bwd": 0, "fwd_bf16": 0,
        "fwd_save_bf16": 0, "bwd_bf16": 0}
    assert json.loads((expdir / "hparams.json").read_text())["opt"][
        "lr"] == "1e-3"
    assert os.path.exists(expdir / "epoch_000" / "state.pt")


def test_evaluate_writes_results_and_skips_if_present(trained_exp, capsys,
                                                       few_threads):
    root, expdir, _ = trained_exp
    res_path = expdir / "results.txt"
    if res_path.exists():
        res_path.unlink()
    res = subprocess.run([sys.executable, "-u", "-m",
                          "leaf_tpu_torch.evaluate",
                          *_eval_args(root, expdir)],
                         capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-2000:]
    body = res_path.read_text()
    lines = body.strip().splitlines()
    assert lines[0] == "model,acc,ckpt", body
    arch, acc, ckpt = lines[1].split(",")
    assert arch == "efficientnet" and ckpt == "epoch_000"
    hits = float(acc) * len(TEST_SECONDS)   # a whole number of clips
    assert abs(hits - round(hits)) < 1e-9, acc
    # a second run skips and leaves the file as it was
    assert evaluate.main(_eval_args(root, expdir)) == 0
    assert "skipping" in capsys.readouterr().out
    assert res_path.read_text() == body
    # --bn_recalibrate N draws from the train manifest
    res_path.unlink()
    assert evaluate.main(_eval_args(root, expdir, (
        "--bn_recalibrate", "2", "--recal_batch_size", "4"))) == 0
    assert "recalibrating BN stats on 2 batches of 4 from train.csv" in \
        capsys.readouterr().out
    assert res_path.read_text().startswith("model,acc,ckpt\nefficientnet,")
    # multilabel scoring: mAP, mAUC and d' of the sigmoid outputs
    res_path.unlink()
    assert evaluate.main(_eval_args(root, expdir,
                                    ("--metrics", "multilabel"))) == 0
    header, row = res_path.read_text().splitlines()
    assert header == "model,mAP,mAUC,dprime,ckpt"
    values = [float(v) for v in row.split(",")[1:4]]
    assert all(np.isfinite(values)) and 0 <= values[0] <= 1, row


@pytest.mark.parametrize("t", [1, 159, 16000, 16001, 23456, 48000])
def test_pad_to_windows_matches_jax(t):
    import evaluate as jax_evaluate
    x = np.random.RandomState(t).randn(t).astype(np.float32)
    got = evaluate.pad_to_windows(x, SR)
    want = jax_evaluate.pad_to_windows(x, SR)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_evaluate_matches_jax_apply(tmp_path, few_threads):
    root = make_tiny_exp(tmp_path)
    from leaf_tpu_torch.training.config import get_config
    cfg = get_config(str(root / "cfg.cfg"))
    jm = JaxClassifier(cfg=cfg)
    x0 = jnp.zeros((2, SR), jnp.float32)
    v0 = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.PRNGKey(3), x0)))
    test_set = JaxDataset(str(root / "test.csv"), str(root / "lbl_map.json"),
                          cfg["audio_config"], mode="multiclass",
                          transform=JaxCompose([JaxPeak(sr=SR)]), is_val=True)
    clips, labels = zip(*(test_set[i] for i in range(len(test_set))))
    windows = [evaluate.pad_to_windows(np.asarray(x), SR) for x in clips]
    # BN stats from the test windows themselves: O(1) logits, and no layer
    # normalised by the variance of another input distribution
    model = load_jax_variables(Classifier(cfg, device="cpu"), v0)
    set_batch_norm_stats_(model, torch.from_numpy(np.concatenate(windows)))
    variables = import_torch_classifier(model.state_dict(), v0,
                                        "efficientnet")
    expdir = tmp_path / "exp"
    save_hparams(str(expdir), cfg)
    save_checkpoint(str(expdir), TrainState(model, None), 0, 1.0, 0.5, 0.5)
    assert evaluate.main(_eval_args(root, expdir)) == 0
    acc = float((expdir / "results.txt").read_text().splitlines()[1]
                .split(",")[1])

    # one JAX forward over every window (eval mode: rows are independent)
    logits = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(np.concatenate(windows))))
    ends = np.cumsum([len(w) for w in windows])
    want = [part.mean(axis=0) for part in np.split(logits, ends[:-1])]
    labels = [int(y) for y in labels]
    assert sorted({len(w) for w in windows}) == [1, 2, 3]
    got = evaluate.score_clips(model, list(clips), SR, "cpu")
    scale = max(np.abs(w).max() for w in want)
    assert scale > 1e-2     # O(1) logits, not a random init's ~1e-8
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-4 * scale
    preds = [int(np.argmax(w)) for w in want]
    assert [int(np.argmax(g)) for g in got] == preds
    assert acc == float(np.mean(np.asarray(preds) == np.asarray(labels)))


def test_rate_tracker_and_logger(tmp_path, capsys):
    tracker = RateTracker()
    tracker.add(10)
    time.sleep(0.6)
    tracker.add(10)
    assert tracker.rate() > 0 and 0 < tracker.global_rate() < 40
    logger = TrainLogger(str(tmp_path / "exp"), use_tensorboard=False)
    logger.print("hello")
    logger.log_scalars({"a": 1.0}, step=0)
    logger.close()
    assert capsys.readouterr().out == "hello\n"
    quiet = TrainLogger(str(tmp_path / "exp2"), is_master=False)
    quiet.print("nothing")
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "exp2").exists()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    with profile_trace(None):   # off: writes nothing
        pass


@pytest.mark.parametrize("flag", [
    ("--steps_per_call", "2"), ("--wandb_watch_model",),
    ("--watch_histograms",), ("--use_packed_dataset",),
    ("--gcs_bucket_name", "b"), ("--n_devices", "2"), ("--multihost",)])
def test_unported_flags_raise(flag, tmp_path):
    # the multistep, watch and packed-shard flags are ported: they pass
    # the refusal (tests/test_torch_port_multistep.py and
    # tests/test_torch_port_packed.py run them); the rest raise
    from leaf_tpu_torch import train
    root = make_tiny_exp(tmp_path)
    argv = ["--cfg_file", str(root / "cfg.cfg"), "--expdir",
            str(tmp_path / "exp"), "--device", "cpu", *flag]
    if flag[0] in ("--steps_per_call", "--wandb_watch_model",
                   "--watch_histograms", "--use_packed_dataset",
                   "--gcs_bucket_name"):
        train._refuse_unported(train.parse_args(argv))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        train.main(argv)


def test_train_bf16_then_evaluate(tmp_path, capsys, few_threads):
    # --bf16 saves compute_dtype bfloat16 in both cfg sections of
    # hparams.json; evaluate builds the bf16 model from it and scores in f32
    from leaf_tpu_torch import train
    root = make_tiny_exp(tmp_path)
    expdir = tmp_path / "exp"
    assert train.main(["--cfg_file", str(root / "cfg.cfg"), "--expdir",
                       str(expdir), "--epochs", "1", "--num_workers", "1",
                       "--device", "cpu", "--bf16"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"epoch 0: tr_loss (\S+) .* val_acc (\S+) ", out)
    assert m and np.isfinite(float(m.group(1))), out[-2000:]
    hp = json.loads((expdir / "hparams.json").read_text())
    assert hp["frontend"]["compute_dtype"] == "bfloat16"
    assert hp["model"]["compute_dtype"] == "bfloat16"
    assert evaluate.main(_eval_args(root, expdir)) == 0
    out = capsys.readouterr().out
    assert ("compute dtype: frontend torch.bfloat16, model torch.bfloat16"
            in out), out
    header, row = (expdir / "results.txt").read_text().splitlines()
    arch, acc, ckpt = row.split(",")
    assert header == "model,acc,ckpt" and arch == "efficientnet"
    assert ckpt == "epoch_000" and 0.0 <= float(acc) <= 1.0
    hits = float(acc) * len(TEST_SECONDS)   # a whole number of clips
    assert abs(hits - round(hits)) < 1e-9, acc


@pytest.mark.parametrize("mode,flags", [
    ("multiclass", ("--host_aug", "--profile_dir", "PROFILE")),
    ("multilabel", ("--high_aug", "--save_every", "2")),
])
def test_train_cli_options(mode, flags, tmp_path, capsys, few_threads):
    # in process: the host-side augment pipelines (float32 wire), the
    # profiler trace, and the multilabel path (mAP on the host)
    from leaf_tpu_torch import train
    root = make_tiny_exp(tmp_path)
    cfg = root / "cfg.cfg"
    cfg.write_text(cfg.read_text().replace("type: multiclass",
                                           f"type: {mode}"))
    flags = [str(tmp_path / "prof") if f == "PROFILE" else f for f in flags]
    assert train.main(["--cfg_file", str(cfg), "--expdir",
                       str(tmp_path / "exp"), "--epochs", "1",
                       "--num_workers", "2", "--device", "cpu",
                       *flags]) == 0
    out = capsys.readouterr().out
    assert "wire: float32" in out
    metric = "val_acc" if mode == "multiclass" else "val_mAP"
    m = re.search(rf"epoch 0: tr_loss (\S+) .* {metric} (\S+) ", out)
    assert m and np.isfinite(float(m.group(1))), out[-2000:]
    assert 0.0 <= float(m.group(2)) <= 1.0
    assert (tmp_path / "exp" / "epoch_000" / "state.pt").exists()
    if "--profile_dir" in flags:
        assert (tmp_path / "prof" / "trace.json").exists()


def test_resnet18_experiment_trains_evaluates_and_exports(tmp_path, capsys,
                                                          few_threads):
    # the tiny experiment behind a ResNet-18 (cfgs/*/resnet-18-leaf-default
    # .cfg's model section): train one epoch, evaluate, and export the
    # checkpoint for serving; the artifact against the live model of it
    from leaf_tpu_torch import export_serving, train
    from leaf_tpu_torch.serving import ServingModel
    from leaf_tpu_torch.training.checkpoint import (best_checkpoint,
                                                    load_hparams)
    root = make_tiny_exp(tmp_path)
    cfg = root / "cfg.cfg"
    cfg.write_text(cfg.read_text().replace(
        "    arch: efficientnet\n    model_depth: b0\n",
        "    arch: resnet\n    model_depth: 18\n    pool: avgpool\n"))
    expdir = tmp_path / "exp"
    assert train.main(["--cfg_file", str(cfg), "--expdir", str(expdir),
                       "--epochs", "1", "--num_workers", "1",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "model params: 11," in out, out[-2000:]
    m = re.search(r"epoch 0: tr_loss (\S+) .* val_acc (\S+) ", out)
    assert m and np.isfinite(float(m.group(1))), out[-2000:]
    assert evaluate.main(_eval_args(root, expdir)) == 0
    header, row = (expdir / "results.txt").read_text().splitlines()
    assert header == "model,acc,ckpt" and row.startswith("resnet,")
    serving = tmp_path / "serving"
    assert export_serving.main(["--exp_dir", str(expdir), "--out_dir",
                                str(serving), "--batch_sizes", "2",
                                "--device", "cpu"]) == 0
    manifest = json.loads((serving / "serving.json").read_text())
    assert manifest["model"] == {"arch": "resnet", "model_depth": 18}
    weights = torch.load(os.path.join(best_checkpoint(str(expdir)),
                                      "state.pt"), weights_only=True)["model"]
    live = ServingModel(load_hparams(str(expdir)), state_dict=weights,
                        device="cpu", batch_sizes=(2,))
    x = (np.random.RandomState(0).randn(3, SR) * 0.1).astype("float32")
    got, ref = ServingModel.load(str(serving), device="cpu")(x), live(x)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
