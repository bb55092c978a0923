"""The port's kernel build (leaf_tpu_torch.ops._build) on the CPU: which
files a library's name hashes. Building needs nvcc and runs on the card
(chip_smoke.py); these tests only read and hash sources."""

from leaf_tpu_torch.ops import _build


def test_sources_hash_the_shared_header():
    for name in ("fwd", "bwd"):
        files = [f.name for f in _build._inputs(_build.SOURCES[name])]
        assert files == [_build.SOURCES[name].name, "hopper_tf32.cuh"]


def test_header_edit_renames_the_library(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    monkeypatch.setitem(_build.SOURCES, "k", tmp_path / "k.cu")
    assert [f.name for f in _build._inputs(tmp_path / "k.cu")] == [
        "k.cu", "a.cuh", "b.cuh"]             # each once, cycles end
    before = _build._target("k")
    assert before.name.startswith("libleaf_k_")
    (tmp_path / "b.cuh").write_text('#pragma once\n// edited\n')
    edited = _build._target("k")
    assert edited != before and _build._target("k") == edited
