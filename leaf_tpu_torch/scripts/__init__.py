"""The port's measurement tools: each is the counterpart of the JAX repo's
``scripts/<name>.py`` of the same name, runs the port's main path on the
card (so it launches the fused frontend kernels), and prints its record
as JSON lines with the card's name, power limit and count.

    python -m leaf_tpu_torch.scripts.<name> [flags] [--device cpu]

- ``kernel_microbench``: the fused op and Leaf forward / fwd+bwd (f32,
  bf16), each of the six kernels against its bound and the cuDNN
  composition (``--shape flagship|audioset``, ``--plain``).
- ``kernel_profile``: the fused op's fwd+bwd under torch.profiler.
- ``step_profile``: the train step, the frontend's fwd+bwd and the
  inference forward under torch.profiler, by kernel and by category.
- ``scan_ab``: ms per step of K steps per call as one CUDA graph.
- ``scan_profile``: the eager step against the K-step graph, per kernel.
- ``serving_latency``: ``ServingModel`` live and exported, per bucket.
- ``streaming_latency``: ``LeafStreamer`` and the exported streamer.
- ``e2e_gap``: the host loader, the copy to the card, the step and both
  together.
- ``dw_ab``, ``dw_layout_ab``: b0's depthwise convolutions against a
  shift-multiply formulation and in channels-last.

Every tool defaults to ``--device cuda`` and exits non-zero without a
card. ``--device cpu`` runs the plain kernel versions and writes ``null``
for every device metric. ``_measure`` holds what they share with
``chip_smoke.py``: the timers, the profile readers, the H100's peaks and
the kernels' bounds. Nothing here imports JAX or ``leaf_tpu``.
"""
