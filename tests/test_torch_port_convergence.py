"""The port's convergence harness, ``python -m
leaf_tpu_torch.synthetic_convergence``, against the JAX harness
``scripts/synthetic_convergence.py`` on the CPU.

- The splits: for both tasks the port's ``make_split`` writes the JAX
  one's manifest byte for byte (files, labels, task and seed columns)
  and the same WAV bytes, and each harness takes the other's split as
  cached (the same reuse rule); the cfg text is the JAX one.
- One tiny run per task (``--device cpu --arch cifar_resnet:20 --clips
  70 --batch 35 --epochs 2``): the children's outputs are recorded and
  replayed into the JAX harness, whose JSON line then has the port's
  keys (the port adds ``kernels``) and the same test metric (a
  multilabel AUC that is undefined at this size is NaN in the port's
  line and missing from the JAX one's). The JAX
  regex also matches train's closing "done. best val_acc" line, so its
  ``final_val_metric`` is the best epoch's; the port's is the last
  epoch's, read from the epoch lines.
- ``--skip_train --bn_recalibrate 2`` re-scores the same experiment.
- The entry points default to the card and raise without one.
"""

import contextlib
import filecmp
import importlib.util
import io
import json
import math
import os
import re
import subprocess

import pytest
import torch

from leaf_tpu_torch import synthetic_convergence as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--arch", "cifar_resnet:20", "--clips", "70",
        "--batch", "35", "--epochs", "2"]


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "_jax_synthetic_convergence",
        os.path.join(REPO, "scripts", "synthetic_convergence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
def test_make_split_matches_jax(task, tmp_path):
    jax_h = _jax_harness()
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    jax_h.make_split(str(a), "train", 70, seed=0, task=task)
    port.make_split(str(b), "train", 70, seed=0, task=task)
    ra, rb = _rows(a / "train.csv"), _rows(b / "train.csv")
    assert ra[0] == rb[0] == "files,labels,task,seed"
    assert len(ra) == len(rb) == 71
    assert [r.replace(str(a), str(b)) for r in ra] == rb
    assert rb[1].endswith(f",{task},0")
    if task == "multilabel":
        assert any("|" in r for r in rb)
    for i in range(70):
        name = f"train/clip{i:05d}.wav"
        assert filecmp.cmp(a / name, b / name, shallow=False), name
    # each harness takes the other's split as cached: nothing rewritten
    stamps = {p: os.stat(p).st_mtime_ns for p in (a / "train.csv",
                                                   b / "train.csv")}
    jax_h.make_split(str(b), "train", 70, seed=0, task=task)
    port.make_split(str(a), "train", 70, seed=0, task=task)
    assert {p: os.stat(p).st_mtime_ns for p in stamps} == stamps
    # another seed is another split
    port.make_split(str(b), "train", 70, seed=1, task=task)
    assert _rows(b / "train.csv")[1].endswith(f",{task},1")
    assert port.CFG == jax_h.CFG


class _Recorder:
    """subprocess.run that records each child's CompletedProcess."""

    def __init__(self, real):
        self.real, self.done = real, []

    def __call__(self, cmd, **kw):
        r = self.real(cmd, **kw)
        self.done.append((cmd, r))
        return r


def _run_port(argv, monkeypatch):
    rec = _Recorder(subprocess.run)
    monkeypatch.setattr(subprocess, "run", rec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port.main(argv) == 0
    monkeypatch.setattr(subprocess, "run", rec.real)
    return json.loads(out.getvalue().strip().splitlines()[-1]), rec.done


def _replay_jax(argv, done, monkeypatch):
    """The JAX harness's JSON line for the port children's outputs."""
    jax_h = _jax_harness()
    replies = iter(r for _, r in done)

    def fake_run(cmd, **kw):
        r = next(replies)
        assert ("train.py" in cmd) == ("leaf_tpu_torch.train" in r.args)
        return r

    monkeypatch.setattr(jax_h.subprocess, "run", fake_run)
    monkeypatch.setattr("sys.argv", ["synthetic_convergence.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_h.main()
    monkeypatch.setattr(jax_h.subprocess, "run", subprocess.run)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """One tiny harness run per task (2 threads per child: the test
    runner shares the cores among its workers)."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        mp.setenv("JAX_PLATFORMS", "cpu")
        for task in ("multiclass", "multilabel"):
            root = tmp_path_factory.mktemp(task)
            argv = [*TINY, "--task", task, "--root", str(root)]
            res, done = _run_port(argv, mp)
            runs[task] = (root, argv, res, done)
    return runs


@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
def test_tiny_run_reports_the_jax_harness_line(task, tiny_runs,
                                               monkeypatch):
    root, argv, res, done = tiny_runs[task]
    train_out = done[0][1].stdout
    assert [c[1:3] for c, _ in done] == [["-m", "leaf_tpu_torch.train"],
                                        ["-m", "leaf_tpu_torch.evaluate"]]
    train_cmd, eval_cmd = done[0][0], done[1][0]
    for flag in ("--bf16", "--labels_delimiter", "--save_every",
                 "--device"):
        assert flag in train_cmd, flag
    assert eval_cmd[eval_cmd.index("--separator") + 1] == "|"
    assert eval_cmd[eval_cmd.index("--metrics") + 1] == task
    assert "bfloat16" in (root / f"exp_cifar_resnet20_{task}" /
                          "hparams.json").read_text()

    ref = _replay_jax([a for a in argv if a not in ("--device", "cpu")],
                      done, monkeypatch)
    # at this size a class may have no positive test clip: its AUC is
    # undefined, evaluate prints nan, and the JAX regex, reading no
    # number there, drops mAUC and dprime where the port reports NaN
    undefined = [k for k in ("mAUC", "dprime")
                 if k in res and math.isnan(res[k])]
    assert [k for k in res if k not in undefined] == list(ref) + ["kernels"]
    assert task == "multilabel" or not undefined
    for key in ref:
        if key not in ("final_val_metric", "train_wall_s"):
            assert res[key] == ref[key], key
    epoch_metrics = [float(v) for v in re.findall(
        r"^epoch \d+: .* val_(?:acc|mAP) (\S+) ", train_out, re.M)]
    assert len(epoch_metrics) == 2
    assert res["final_val_metric"] == epoch_metrics[-1]
    assert ref["final_val_metric"] == max(epoch_metrics)
    for key in ("value", "final_val_metric"):
        assert isinstance(res[key], float) and 0.0 <= res[key] <= 1.0, key
    assert res["metric"] == ("synthetic_convergence_test_"
                             + ("mAP" if task == "multilabel" else "acc"))
    assert res["train_wall_s"] > 0 and res["bn_recalibrate"] == 0
    # the CPU runs the kernels' plain versions: no launch
    assert res["kernels"] == dict.fromkeys(
        ("fwd", "fwd_save", "bwd", "fwd_bf16", "fwd_save_bf16",
         "bwd_bf16"), 0)


def test_skip_train_bn_recalibrate_rescores(tiny_runs, monkeypatch):
    root, argv, first, _ = tiny_runs["multiclass"]
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    res_txt = root / "exp_cifar_resnet20_multiclass" / "results.txt"
    assert res_txt.exists()
    before = res_txt.stat().st_mtime_ns
    res, done = _run_port([*argv, "--skip_train", "--bn_recalibrate", "2"],
                          monkeypatch)
    cmd = done[0][0]
    assert len(done) == 1 and "leaf_tpu_torch.evaluate" in cmd
    assert cmd[cmd.index("--recal_batch_size") + 1] == "35"
    assert "recalibrating BN stats on 2 batches" in done[0][1].stdout
    assert res_txt.stat().st_mtime_ns != before
    assert 0.0 <= res["value"] <= 1.0
    assert res["bn_recalibrate"] == 2 and res["train_wall_s"] == 0.0
    assert res["kernels"] is None
    # the last epoch's checkpoint holds the final val metric
    assert res["final_val_metric"] == pytest.approx(
        first["final_val_metric"], abs=5e-5)


@pytest.mark.parametrize("entry", ["synthetic_convergence",
                                   "import_torch_classifier",
                                   "convert_torch_checkpoint"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card behaviour")
    import importlib
    mod = importlib.import_module(f"leaf_tpu_torch.{entry}")
    pth = tmp_path / "ckpt.pth"
    torch.save({"model_state_dict": {}}, pth)
    argv = {"synthetic_convergence": ["--root", str(tmp_path / "root")],
            "import_torch_classifier": [str(pth), str(pth),
                                        str(tmp_path / "out")],
            "convert_torch_checkpoint": [str(pth), str(tmp_path / "out")]}
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv[entry])
    assert not (tmp_path / "root").exists()
    assert not (tmp_path / "out").exists()
