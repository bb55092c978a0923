"""ServingModel's CUDA graph per bucket (leaf_tpu_torch.serving), from the
CPU: a CPU model captures nothing and calls the module or program as it
is, the graph counters exist and start empty, their product is taken per
bucket, and ``save_exported`` captures nothing. The graphs themselves run
on the card (tests/test_torch_port_cuda.py)."""

import threading

import numpy as np
import pytest
import torch

from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.serving import ServingModel, save_exported

T = 800
CFG = {"frontend": {"name": "leaf", "default_args": False, "n_filters": 4},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "cifar_resnet", "model_depth": 20, "num_classes": 3}}
BUCKETS = (2, 4)


@pytest.fixture(scope="module")
def weights():
    return Classifier(CFG, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("serving_graph")
    save_exported(str(out), CFG, state_dict=weights, batch_sizes=BUCKETS,
                  clip_samples=T, device="cpu")
    return str(out)


def _server(kind, weights, artifact):
    if kind == "live":
        return ServingModel(CFG, state_dict=weights, device="cpu",
                            batch_sizes=BUCKETS, clip_samples=T)
    return ServingModel.load(artifact, device="cpu")


def _waveforms(n, seed=0):
    return (np.random.RandomState(seed).randn(n, T) * 0.1).astype(np.float32)


def _nothing_captured(server):
    assert server.replays == {} and server.per_replay == {}
    assert server.pool_bytes == 0 and server.graph_launch_counts() == {}
    assert server._graphs == {} and server._inputs == {}


@pytest.mark.parametrize("kind", ["live", "loaded"])
def test_counters_exist_and_start_empty(kind, weights, artifact):
    _nothing_captured(_server(kind, weights, artifact))


@pytest.mark.parametrize("kind", ["live", "loaded"])
def test_cpu_model_captures_nothing(kind, weights, artifact):
    server = _server(kind, weights, artifact)
    for n in (1, 4, 6, 6):       # a first and a later chunk of each bucket
        assert server(_waveforms(n)).shape == (n, 3)
    _nothing_captured(server)


@pytest.mark.parametrize("kind", ["live", "loaded"])
def test_cpu_logits_are_the_modules_own(kind, weights, artifact):
    # 6 clips: a chunk of 4, then 2 padded to 2; each chunk is the
    # module's (or program's) own forward at its bucket, bit for bit
    server = _server(kind, weights, artifact)
    x = _waveforms(6, seed=1)
    with torch.inference_mode():
        want = np.concatenate([
            server._forward[4](torch.from_numpy(x[:4])).numpy(),
            server._forward[2](torch.from_numpy(x[4:])).numpy()])
    assert np.array_equal(server(x), want)
    assert np.array_equal(server(x), want)


def test_save_exported_captures_nothing(weights, tmp_path, monkeypatch):
    built = []
    real = ServingModel._init_graphs

    def record(self):
        real(self)
        built.append(self)

    def refuse(*args, **kwargs):
        raise AssertionError("save_exported ran a forward or a capture")

    monkeypatch.setattr(ServingModel, "_init_graphs", record)
    monkeypatch.setattr(ServingModel, "_run", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    save_exported(str(tmp_path), CFG, state_dict=weights,
                  batch_sizes=BUCKETS, clip_samples=T, device="cpu")
    live, = built
    _nothing_captured(live)


def test_graph_launch_counts_are_per_replay_times_replays():
    server = ServingModel.__new__(ServingModel)
    server.per_replay = {8: {"fwd": 1, "depthwise_fwd": 16},
                         64: {"fwd": 1, "depthwise_fwd": 16},
                         256: {"fwd_bf16": 1}}
    server.replays = {8: 3, 64: 0, 256: 2}
    assert server.graph_launch_counts() == {"fwd": 3, "depthwise_fwd": 48,
                                            "fwd_bf16": 2}


def test_threads_sharing_a_cpu_model_get_their_own_logits(weights, artifact):
    server = _server("live", weights, artifact)
    requests = [_waveforms(n, seed=10 + n) for n in (3, 4)]
    want = [server(x) for x in requests]
    got, errors = [[], []], []

    def caller(i):
        try:
            for _ in range(4):
                got[i].append(server(requests[i]))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert errors == []
    for i in (0, 1):
        assert len(got[i]) == 4
        assert all(np.array_equal(g, want[i]) for g in got[i])
