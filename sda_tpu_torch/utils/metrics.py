"""Device profiling (counterpart of ``jax_trace`` in
``sda_tpu/utils/metrics.py``; the ``Metrics`` facade there is JAX-free,
serves the client and server planes, and stays in ``sda_tpu``)."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block: CPU activity, plus
    CUDA activity when a GPU is present, written on exit as a Chrome trace
    (``*.pt.trace.json``, TensorBoard's profiler format) under
    ``log_dir``. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
