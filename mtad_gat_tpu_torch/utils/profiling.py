"""Profiling helpers: the port of ``mtad_gat_tpu/utils/profiling.py``.

``trace(log_dir)`` records a ``torch.profiler`` trace of its block and
writes it under ``log_dir`` as ``<host>_rank<r>.<ns>.pt.trace.json``
(``torch.profiler.tensorboard_trace_handler``): one file a rank, so that
every rank of a mesh writes its own, as every JAX process calls
``jax.profiler.start_trace`` for itself. View it in TensorBoard's profiler
plugin, Perfetto or ``chrome://tracing``. On a CUDA device it records the
host's operators and the device's kernels and copies (CUPTI), and raises
if the trace holds no device event rather than hand back a host-only
trace. ``force_completion`` waits for the device work on some tensors, and
``timed`` is a wall-clock section timer.
"""

from __future__ import annotations

import contextlib
import socket
import time
from typing import Iterator, Optional

import torch

from mtad_gat_tpu_torch.parallel import multihost


def worker_name(rank: int, host: str) -> str:
    """The trace file's worker name: the host and the rank."""
    return f"{host}_rank{rank}"


def _device_events(prof) -> int:
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its trace under ``log_dir``. ``device``
    (default: the GPU when there is one) says whether to record the
    device's activity as well as the host's."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    name = worker_name(multihost.process_info()[0], socket.gethostname())
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir, worker_name=name)) as prof:
        yield prof
    if on_cuda and not _device_events(prof):
        raise RuntimeError(
            f"trace: the profile written under {log_dir} holds no CUDA event; the "
            "profiler could not record the device's activity")


def force_completion(tensors) -> None:
    """Wait until the device has finished the work on ``tensors`` (a tensor
    or an iterable of them): ``torch.cuda.synchronize`` on the first CUDA
    tensor's device. The JAX package fetches a scalar for the same end."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


@contextlib.contextmanager
def timed(label: str, result_holder: Optional[dict] = None) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[label] = dt
    print(f"[timed] {label}: {dt*1e3:.2f} ms")
