"""The port's config reader (leaf_tpu_torch.training.config) against the JAX
package's, which reads the files with PyYAML's FullLoader.

Values and their types must be equal: YAML 1.1 reads ``lr: 1e-3`` as the
*string* '1e-3' (no dot), ``test_manifest: None`` as the string 'None',
``True`` as a boolean; the CLIs rely on those types. Constructs outside
the subset the port reads must raise, never be guessed.
"""

import importlib.util
import math
import pathlib

import pytest
import yaml

from leaf_tpu.training import config as jconfig
from leaf_tpu_torch.training import config

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG_FILES = sorted((REPO / "cfgs").rglob("*.cfg"))


def _assert_same(a, b, where="cfg"):
    assert type(a) is type(b), (where, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, float) and math.isnan(b):
        assert math.isnan(a), (where, a)
    else:
        assert a == b, (where, a, b)


def test_all_repo_cfgs_are_read():
    assert len(CFG_FILES) == 14


@pytest.mark.parametrize("path", CFG_FILES,
                         ids=[str(p.relative_to(REPO)) for p in CFG_FILES])
def test_get_config_matches_jax(path):
    got = config.get_config(str(path))
    _assert_same(got, jconfig.get_config(str(path)))
    assert got["opt"]["lr"] == "1e-3"  # a string, as PyYAML reads it
    assert float(got["opt"]["weight_decay"]) in (1e-4, 0.0)


def _synthetic_convergence_cfg(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "synthetic_convergence", REPO / "scripts" / "synthetic_convergence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = mod.CFG.format(arch="efficientnet", depth="b0", task="multiclass",
                          warmup=2, batch=256, root=tmp_path,
                          train_csv="train.csv", val_csv="val.csv",
                          test_csv="test.csv")
    path = tmp_path / "synthetic.cfg"
    path.write_text(text)
    return path


def _port_synthetic_convergence_cfg(tmp_path):
    from leaf_tpu_torch.synthetic_convergence import CFG
    text = CFG.format(arch="resnet", depth="18", task="multilabel",
                      warmup=6, batch=256, root=tmp_path,
                      train_csv="train_multilabel.csv",
                      val_csv="val_multilabel.csv",
                      test_csv="test_multilabel.csv")
    path = tmp_path / "port_synthetic.cfg"
    path.write_text(text)
    return path


def _preemption_cfg(tmp_path):
    from tests.test_preemption import make_tiny_exp
    return make_tiny_exp(tmp_path) / "cfg.cfg"


@pytest.mark.parametrize("make", [_synthetic_convergence_cfg,
                                  _port_synthetic_convergence_cfg,
                                  _preemption_cfg])
def test_script_and_test_cfgs_match_jax(make, tmp_path):
    path = make(tmp_path)
    _assert_same(config.get_config(str(path)),
                 jconfig.get_config(str(path)))


# plain and quoted scalars, as `key: <text>`; PyYAML is the reference
SCALARS = [
    "1e-3", "1.0e-3", "1.e+3", "1e+3", "1.5", ".5", "3.", "-2.5", "+1.0",
    "1_000.5", ".inf", "-.Inf", "+.INF", ".nan", "0", "-0", "+12", "1_000",
    "0x1F", "-0x1f", "017", "0b101", "09", "8881", "yes", "Yes", "NO", "on",
    "Off", "true", "False", "TRUE", "tRue", "y", "n", "~", "null", "Null",
    "None", "none", "NULL", "leaf", "avgpool", "/data/x_1/meta", "a#b",
    "leaf # a comment", "-1", "-a", "a b  c", "'single'", "'it''s'",
    "'1e-3'", '"double"', '"tab\\tand \\"quote\\" \\x41\\u00e9"',
    '"True"', "''", '""', "efficientnet-b0", "3 # x", "kaiming_normal",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_resolution_matches_pyyaml(text):
    doc = f"section:\n    key: {text}\n"
    want = yaml.load(doc, yaml.FullLoader)
    _assert_same(config.parse_config_text(doc), want)


def test_structure_matches_pyyaml():
    doc = ("# header comment\n\nfrontend:\n  name: leaf  # trailing\n\n"
           "  # indented comment\n  empty:\n  n: 8\nmodel:\ntop: 3\n"
           "opt:\n    lr: 1e-3\n    lr: 2e-3\n")
    _assert_same(config.parse_config_text(doc),
                 yaml.load(doc, yaml.FullLoader))


UNSUPPORTED = [
    "a:\n  - 1\n",                  # sequence
    "a:\n  b: [1, 2]\n",            # flow sequence
    "a:\n  b: {c: 1}\n",            # flow mapping
    "a:\n  b: &x 1\n",              # anchor
    "a:\n  b: *x\n",                # alias
    "a:\n  b: !!str 1\n",           # tag
    "a:\n  b: |\n    text\n",       # block scalar
    "a:\n  b:\n    c: 1\n",         # third level
    "a:\n    b: 1\n  c: 2\n",       # uneven indentation
    "a:\n\tb: 1\n",                 # tab indentation
    "---\na:\n  b: 1\n",            # document marker
    "a:\n  b: c: d\n",              # nested mapping in a value
    "a:\n  b: 1:30\n",              # sexagesimal
    "a:\n  b: 2001-12-14\n",        # timestamp
    "a:\n  b: \"open\n",            # multi-line quoted scalar
    "a:\n  b: 'x' y\n",             # text after a quoted scalar
    "a:\n  b: @x\n",                # reserved indicator
    "  a: 1\n",                     # indented line outside a section
    "a:\n  True: 1\n",              # non-string key
    "just text\n",                  # not key: value
]


@pytest.mark.parametrize("doc", UNSUPPORTED)
def test_constructs_outside_the_subset_raise(doc):
    with pytest.raises(ValueError, match="outside the YAML subset"):
        config.parse_config_text(doc)


def _flagship_text():
    return (REPO / "cfgs/speechcommands/efficientnet-b0-leaf-default.cfg"
            ).read_text()


@pytest.mark.parametrize("drop", ["section", "key"])
def test_missing_section_or_key_raises_like_jax(drop, tmp_path):
    text = _flagship_text()
    if drop == "section":
        text = text.replace("opt:\n", "optx:\n")
        text = "\n".join(ln for ln in text.splitlines()
                         if not ln.startswith("optx:"))
    else:
        text = text.replace("    batch_size: 256\n", "")
    path = tmp_path / "bad.cfg"
    path.write_text(text)
    with pytest.raises(KeyError) as jerr:
        jconfig.get_config(str(path))
    with pytest.raises(KeyError) as err:
        config.get_config(str(path))
    assert str(err.value) == str(jerr.value)
