"""Training traffic: the recipe's data path into ``TrainMultistep``.

The mix's data file gives the number of clips, K (``steps_per_call``)
and the labels per clip; the configuration gives the batch, the clip
length, the classes and the schedule. Set-up writes the seed's clips as
16-bit WAVs under ``TMPDIR``, reads them through the port's
``RawWaveformDataset`` (``in_memory``, its cache filled during set-up,
int16 on the wire), its ``DataLoader`` (one shuffled epoch after
another), K-stacks batches on the feeder thread and places them with
``prefetch_to_device`` / ``pinned_placer``, as the train CLI's
single-process feed does (``train._run_epochs``; the K-group stacking is
copied here), and builds the state:
the cfg's ``Classifier`` with the benchmark's weights, capturable Adam and
its schedule, ``make_train_multistep(K)`` with the device augment, and a
device generator from the seed.

The first two calls (the first runs K eager steps and then captures the
CUDA graph, the second is its first replay) are set-up; the window then
calls the same object on the next groups for ``--seconds``. A call
returns before the card has run it, so the loop waits for the call
``IN_FLIGHT`` calls back before it makes the next: the card always has
work queued, and the window ends within that many calls of ``--seconds``
(unthrottled, the host ran up to 16 s ahead of a 5 s window on the H100).
After it the port's state is freed and the reference follows the two
calls' steps on the same rows with the same generator draws, the second
from the port's own state after the first (``check.train_numbers``).
"""

from __future__ import annotations

import collections
import gc
import itertools
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from leafbench import check, inputs
from leafbench.cell import Cell, Outcome
from leafbench.measure import trace
from leafbench.reference import step as ref_step
from leafbench.reference.classifier import Classifier as RefClassifier
from leafbench.reference.classifier import backbone_module


IN_FLIGHT = 2
NUM_WORKERS = 4          # the loader's threads
WIRE_DTYPE = "int16"     # the dataset's cache and the loader's batches


def shapes(cell: Cell) -> dict:
    cfg = cell.cfg
    sr = int(cfg["audio_config"]["sample_rate"])
    return {"b": int(cfg["opt"]["batch_size"]),
            "t": int(float(cfg["audio_config"]["random_clip_size"]) * sr),
            "sr": sr, "k": int(cell.traffic["steps_per_call"]),
            "classes": int(cfg["model"]["num_classes"]),
            "multilabel": cfg["model"]["type"] == "multilabel",
            "f": int(40 if cfg["frontend"].get("default_args")
                     else cfg["frontend"].get("n_filters", 40))}


def make_inputs(cell: Cell) -> dict:
    """The seed's clips (int16), label ids and weights."""
    sh, tr = shapes(cell), cell.traffic
    seeds = inputs.Seeds(cell.seed)
    pcm = inputs.to_pcm16(inputs.tone_clips(
        seeds.torch_seed("clips"), int(tr["clips"]), sh["t"], sh["sr"],
        cell.device))
    ids = inputs.labels(seeds.numpy("labels"), len(pcm), sh["classes"],
                        sh["multilabel"],
                        tuple(tr.get("labels_per_clip", (1, 1))))
    ref = RefClassifier(cell.cfg, device=cell.device)
    weights = inputs.make_weights(ref, seeds.torch_seed("weights"),
                                  backbone_module(cell.cfg).weight_std)
    del ref
    return {"pcm": pcm, "ids": ids, "weights": weights,
            "targets": inputs.label_targets(ids, sh["classes"],
                                            sh["multilabel"]),
            "step_seed": seeds.torch_seed("step"),
            "sampler_seed": seeds.torch_seed("sampler") % 2 ** 31}


def _epochs(loader):
    for epoch in itertools.count():
        loader.set_epoch(epoch)
        yield from loader


def _groups(batches, k: int):
    """K consecutive host batches, stacked (every batch has one shape)."""
    while True:
        group = list(itertools.islice(batches, k))
        if len(group) < k:
            return
        yield (np.stack([np.asarray(b[0]) for b in group]),
               np.stack([np.asarray(b[1]) for b in group]))


class Program:
    """The port's training system under test, built from the cell."""

    def __init__(self, cell: Cell, data: dict, root: str, marks=None):
        marks = [] if marks is None else marks
        from leaf_tpu_torch.data import (DataLoader, RawWaveformDataset,
                                         ShardedSampler, leaf_device_augment,
                                         leaf_host_crop_transforms,
                                         pinned_placer, prefetch_to_device)
        from leaf_tpu_torch.models import Classifier
        from leaf_tpu_torch.training import (TrainState, make_train_multistep,
                                             optimization_helper)
        sh, cfg = shapes(cell), cell.cfg
        manifest, label_map = inputs.write_dataset(
            root, data["pcm"], data["ids"], sh["classes"], sh["sr"])
        mode = "multilabel" if sh["multilabel"] else "multiclass"
        self.dataset = RawWaveformDataset(
            manifest, label_map, cfg["audio_config"], mode=mode,
            transform=leaf_host_crop_transforms(True, sh["t"]),
            in_memory=bool(cfg["data"].get("in_memory", False)),
            wire_dtype=WIRE_DTYPE)
        marks.append(("wavs", time.monotonic() - cell.t0))
        if self.dataset.in_memory:           # fill its cache in set-up
            for i in range(len(self.dataset)):
                self.dataset[i]
        marks.append(("cache", time.monotonic() - cell.t0))
        loader = DataLoader(
            self.dataset, sh["b"],
            sampler=ShardedSampler(len(self.dataset), shuffle=True,
                                   seed=data["sampler_seed"]),
            target_len=sh["t"], multiclass=not sh["multilabel"],
            num_workers=NUM_WORKERS, drop_last=True)
        self._batches = _epochs(loader)
        self.feed = prefetch_to_device(_groups(self._batches, sh["k"]),
                                       pinned_placer(cell.device))
        model = Classifier(cfg, device=cell.device)
        model.load_state_dict(data["weights"])
        marks.append(("model", time.monotonic() - cell.t0))
        sched = cell.config["schedule"]
        opt, scheduler, _, _ = optimization_helper(
            cfg, model.parameters(),
            num_tr_steps_per_epoch=int(sched["steps_per_epoch"]),
            num_epochs=int(sched["epochs"]),
            capturable=cell.device.type == "cuda")
        marks.append(("optimizer", time.monotonic() - cell.t0))
        self.state = TrainState(model, opt, scheduler)
        self.step = make_train_multistep(sh["k"], cfg["model"]["type"],
                                         augment_fn=leaf_device_augment)
        self.gen = torch.Generator(device=cell.device).manual_seed(
            data["step_seed"])

    def __call__(self, xs, ys):
        return self.step(self.state, xs, ys, self.gen)

    def close(self) -> None:
        self.feed.close()           # stops and joins the feeder thread
        try:
            self._batches.close()   # stops the loader's worker threads
        except ValueError:
            pass
        self.dataset._cache.clear()


def port_state(state) -> dict:
    """A ``TrainState``'s model and Adam, in ``reference.step.Trainer
    .state``'s form (a moment the optimizer has not made reads 0)."""
    st = state.optimizer.state
    named = list(state.model.named_parameters())

    def moment(p, key):
        return (st[p][key].cpu().clone() if key in st.get(p, {})
                else torch.zeros(p.shape))
    steps = [float(st[p]["step"]) for _, p in named if "step" in
             st.get(p, {})]
    return {"model": {k: v.detach().cpu().clone() for k, v in
                      state.model.state_dict().items()},
            "exp_avg": {n: moment(p, "exp_avg") for n, p in named},
            "exp_avg_sq": {n: moment(p, "exp_avg_sq") for n, p in named},
            "step": int(max(steps, default=0))}


def port_readings(cell: Cell, prog: Program) -> dict:
    """The two checked calls, through the window's own call and feed:
    their rows, mean losses, the logits of the first step (a forward hook
    on the model that copies its first output and removes itself, before
    the CUDA graph is captured) and the state after each."""
    fed, losses, states, first = [], [], [], {}

    def hook(module, args, output):
        first["logits"] = output.detach().clone()
        handle.remove()

    handle = prog.state.model.register_forward_hook(hook)
    for _ in range(2):
        xs, ys = next(prog.feed)
        fed.append((xs, ys))
        losses.append(float(prog(xs, ys)["loss"]))
        states.append(port_state(prog.state))
    return {"fed": fed, "losses": losses, "states": states,
            "first_logits": first["logits"].cpu()}


def reference_readings(cell: Cell, data: dict, fed, *, restart=None,
                       keep_rows=None) -> dict:
    """The reference's steps on the rows the two checked calls were fed:
    each call's mean loss, the first step's logits and the state after
    each call, the second call started from ``restart`` (a state after
    the first call) where one is given."""
    sh = shapes(cell)
    rows = torch.cat([xs.reshape(-1, sh["t"]) for xs, _ in fed])
    index = check.match_rows(rows.cpu().numpy(), data["pcm"])
    ys = torch.cat([y.reshape(len(y) * sh["b"], *y.shape[2:])
                    for _, y in fed])
    bad = check.rows_bad(index, ys, data["targets"])
    if bad:
        return {"rows_bad": bad}
    model = RefClassifier(cell.cfg, device=cell.device)
    model.load_state_dict(data["weights"])
    gen = torch.Generator(device=cell.device).manual_seed(data["step_seed"])
    x = torch.from_numpy(data["pcm"][index]).to(cell.device)
    y = data["targets"][index].to(cell.device)
    batches = [(x[i:i + sh["b"]].float() * (1.0 / 32768.0),
                y[i:i + sh["b"]]) for i in range(0, len(index), sh["b"])]
    sched = cell.config["schedule"]
    lr = ref_step.schedule(cell.cfg["opt"], int(sched["steps_per_epoch"]),
                           int(sched["epochs"]))
    trainer = ref_step.Trainer(
        model, gen, cell.cfg["model"]["type"],
        float(cell.cfg["opt"].get("weight_decay", 0.0)), keep_rows)
    k = sh["k"]
    losses, states, first = [], [], None
    for c in range(2):
        if c == 1 and restart is not None:
            trainer.load(restart)
        got, logits = trainer.call(batches[c * k:(c + 1) * k],
                                   [lr(i) for i in range(c * k,
                                                         (c + 1) * k)])
        first = logits if first is None else first
        losses.append(float(np.mean(got)))
        states.append(trainer.state())
    return {"losses": losses, "states": states, "first_logits": first,
            "rows_bad": 0}


def numbers(data: dict, port: dict, ref: dict) -> dict:
    if ref["rows_bad"]:
        return {"rows_bad": ref["rows_bad"]}
    out = check.train_numbers(check.start_state(data["weights"]), port, ref)
    out["rows_bad"] = 0
    return out


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(cell: Cell) -> Outcome:
    sh = shapes(cell)
    marks = [("start", time.monotonic() - cell.t0)]
    data = make_inputs(cell)
    marks.append(("inputs", time.monotonic() - cell.t0))
    root = tempfile.mkdtemp(prefix="leafbench-", dir=cell.tmpdir)
    try:
        prog = Program(cell, data, root, marks)
        marks.append(("program", time.monotonic() - cell.t0))
        port = port_readings(cell, prog)
        marks.append(("checked calls", time.monotonic() - cell.t0))
        wait, losses, pending = 0.0, [], collections.deque()
        gpu = cell.device.type == "cuda"
        with trace.traced(cell.trace) as traced:
            with record_function(trace.WINDOW):
                t_start = time.perf_counter()
                setup_s = time.monotonic() - cell.t0
                deadline = t_start + cell.seconds
                while True:
                    t = time.perf_counter()
                    with record_function("leafbench.fetch"):
                        xs, ys = next(prog.feed)
                    wait += time.perf_counter() - t
                    with record_function("leafbench.step"):
                        losses.append(prog(xs, ys)["loss"])
                    if gpu:
                        pending.append(torch.cuda.Event())
                        pending[-1].record()
                        if len(pending) > IN_FLIGHT:
                            pending.popleft().synchronize()
                    if time.perf_counter() >= deadline:
                        break
                if cell.device.type == "cuda":
                    torch.cuda.synchronize(cell.device)
                t_end = time.perf_counter()
        window_s = t_end - t_start
        calls = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) * sh["k"]
        peak = (torch.cuda.max_memory_allocated(cell.device)
                if cell.device.type == "cuda" else 0)
        prog.close()
        del prog, xs, ys, losses
        free(cell.device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    steps = calls * sh["k"]
    t_ref = time.perf_counter()
    ref = reference_readings(cell, data, port["fed"],
                             restart=port["states"][0])
    got = numbers(data, port, ref)
    t_ref = time.perf_counter() - t_ref
    port.pop("fed")
    ctx = {"kind": "train", "timeline": traced.timeline,
           "window_s": window_s, "units": steps, "clips": steps * sh["b"],
           "data_wait_s": wait,
           "frontend_calls": [("fwd_save", sh["b"], sh["t"], sh["f"], 4),
                              ("bwd", sh["b"], sh["t"], sh["f"], 4)],
           "flops_per_unit": (lambda: _flops(cell))}
    return Outcome(
        e2e={"train_clips_per_s": steps * sh["b"] / window_s,
             "setup_s": setup_s},
        attempted=steps, failed=failed, memory_peak_bytes=int(peak),
        ctx=ctx,
        checks=[(name, float(value), float(cell.limits[name]))
                for name, value in got.items()
                if cell.limits.get(name) is not None],
        notes=[f"set-up at s: " + ", ".join(f"{k} {v:.3f}" for k, v in marks),
               f"window {window_s:.6f} s, {calls} calls of {sh['k']} "
               f"steps, data wait {wait * 1e3:.3f} ms in all; reference "
               f"check {t_ref:.3f} s"]
        + [f"reading {name} {value!r} (not compared)"
           for name, value in got.items() if cell.limits.get(name) is None])


def _flops(cell: Cell) -> float:
    from leafbench.reference.flops import count
    sh = shapes(cell)
    return count(cell.cfg, sh["b"], sh["t"], train=True)
