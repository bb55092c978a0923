"""The port's forward smoke and recipe sweeps against the JAX repo's
``scripts/smoke_leaf.py``, ``scripts/speechcommands_init_exps.sh`` and
``scripts/voxceleb_run.sh``, on the CPU.

- ``python -m leaf_tpu_torch.scripts.smoke_leaf --device cpu`` prints the
  JAX script's lines, ``output: (1, 100, 40)``; its ``Leaf()`` holds the
  JAX ``Leaf()``'s initial parameters exactly and, on a numpy-seeded
  waveform, gives the JAX ``Leaf``'s output to 1e-5; without a card and
  without ``--device cpu`` it raises.
- Each sweep, run by bash with a stub ``python`` first on ``PATH`` that
  records its arguments, runs exactly the JAX script's grid (15 and 10
  runs: the cfgs, seeds 8881–8885, ``--expdir``, ``--epochs``,
  ``--random_seed``) as ``python -m leaf_tpu_torch.train`` from the
  repository root, under its own default ``EXP_ROOT`` and with the
  caller's ``EXP_ROOT`` / ``EPOCHS``; extra arguments reach every run.
"""

import contextlib
import io
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.frontend import Leaf as JaxLeaf
from leaf_tpu_torch.frontend import Leaf
from leaf_tpu_torch.models import load_jax_variables
from leaf_tpu_torch.scripts import smoke_leaf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
STUB = """#!/usr/bin/env bash
{ printf '%s' "$PWD"; for a in "$@"; do printf '\\t%s' "$a"; done
  printf '\\n'; } >> "$STUB_LOG"
"""


def test_smoke_leaf_prints_the_jax_lines():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert smoke_leaf.main(["--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "input: (1, 16000)"
    assert lines[1] == "output: (1, 100, 40)"
    lo, hi, mean = (float(v) for v in lines[2].split(":")[1].split())
    assert 0 < lo <= mean <= hi and np.isfinite(hi)


def test_smoke_leaf_matches_the_jax_leaf():
    leaf, _, _ = smoke_leaf.smoke("cpu")
    x = (np.random.RandomState(0).randn(1, 16000)).astype(np.float32)
    jm = JaxLeaf()
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = leaf(torch.from_numpy(x)).numpy()
    # the mel init is seed-free: the smoke's Leaf starts where JAX's does
    carried = load_jax_variables(
        Leaf(device="cpu"),
        jax.tree_util.tree_map(np.asarray, dict(v)))
    for k, t in leaf.state_dict().items():
        assert torch.equal(carried.state_dict()[k], t), k
    assert got.shape == ref.shape == (1, 100, 40)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_smoke_leaf_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke_leaf.main([])


def _run_sweep(script, tmp_path, tag, cwd, overrides=(), args=()):
    """The stub's records of a sweep's runs: [cwd, argv...] per run."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    stub = bin_dir / "python"
    stub.write_text(STUB)
    stub.chmod(0o755)
    log = tmp_path / f"{tag}.log"
    env = {k: v for k, v in os.environ.items()
           if k not in ("EXP_ROOT", "EPOCHS")}
    env.update(overrides, STUB_LOG=str(log),
               PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    subprocess.run(["bash", script, *args], check=True, env=env, cwd=cwd,
                   timeout=60)
    return [ln.split("\t") for ln in log.read_text().splitlines()]


def _port_script(name):
    return os.path.join(REPO, "leaf_tpu_torch", "scripts", f"{name}.sh")


SWEEPS = {
    "speechcommands_init_exps": (
        "./experiments/scv2_init_sweep", "./experiments/torch_scv2_init_sweep",
        ["speechcommands/efficientnet-b0-leaf-default_random",
         "speechcommands/efficientnet-b0-leaf-default_kaiming",
         "speechcommands/efficientnet-b0-leaf-default_xavier"]),
    "voxceleb_run": (
        "./experiments/voxceleb", "./experiments/torch_voxceleb",
        ["voxceleb/efficientnet-b0-leaf-default",
         "voxceleb/resnet-18-leaf-default"]),
}


@pytest.mark.parametrize("overrides", [{}, {"EXP_ROOT": "/data/sweep",
                                            "EPOCHS": "7"}],
                         ids=["defaults", "overridden"])
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_runs_the_jax_grid_on_the_port(name, overrides, tmp_path):
    jax_root, port_root, cfgs = SWEEPS[name]
    root = overrides.get("EXP_ROOT", port_root)
    epochs = overrides.get("EPOCHS", "100")
    want = [[REPO, "-m", "leaf_tpu_torch.train",
             "--cfg_file", f"cfgs/{cfg}.cfg",
             "--expdir", f"{root}/{cfg.split('/')[1]}_seed{seed}",
             "--epochs", epochs, "--random_seed", str(seed)]
            for cfg in cfgs for seed in range(8881, 8886)]
    # from any directory: the sweep runs from the repository root
    got = _run_sweep(_port_script(name), tmp_path, "port", tmp_path,
                     overrides)
    assert len(got) == 5 * len(cfgs) in (15, 10)
    assert got == want
    for run in got:
        assert os.path.exists(os.path.join(REPO, run[4])), run[4]
    # the JAX script (run from the repository root, as it must be): the
    # same runs with `python train.py`, under the JAX sweep's EXP_ROOT
    jax_runs = _run_sweep(os.path.join(REPO, "scripts", f"{name}.sh"),
                          tmp_path, "jax", REPO, overrides)
    moved = [[a.replace(jax_root, port_root, 1) if a.startswith(jax_root)
              else a for a in r] for r in jax_runs]
    assert [r[:2] for r in jax_runs] == [[REPO, "train.py"]] * len(want)
    assert [[REPO, "-m", "leaf_tpu_torch.train", *r[2:]] for r in moved] \
        == want


def test_sweep_passes_extra_arguments(tmp_path):
    runs = _run_sweep(_port_script("voxceleb_run"), tmp_path, "port",
                      tmp_path, args=("--bf16", "--device", "cpu"))
    assert len(runs) == 10
    assert all(r[-3:] == ["--bf16", "--device", "cpu"] for r in runs)
