"""Multi-process runtime: the process group, each rank's device, its share of
a batch, and the launch of a mesh's ranks.

The port of ``mtad_gat_tpu/parallel/multihost.py``. One rank is one process
and one device: rank r runs on ``cuda:(r % torch.cuda.device_count())``, or
on the CPU. The backend is NCCL where every rank can have a card of its own
(no more ranks than visible cards); otherwise gloo, and the collectives of
``parallel/sharding.py`` then stage CUDA tensors through host memory. Every
process group is created with a finite timeout, so a rank that dies ends
the others' collectives with an error rather than a hang.

Two ways to make ranks:

- ``spawn(n, fn, args)``: n local ranks from this process (the ``spawn``
  start method, since CUDA cannot be forked), each running ``fn(*args)``
  in an initialized group; it returns rank 0's result and raises when a
  rank fails;
- ``initialize(coordinator, num_processes, process_id)``: this process
  becomes one rank of a group started elsewhere (the counterpart of
  ``jax.distributed.initialize``).

Every rank computes the same seeded shuffle, and ``host_local_starts``
keeps its data slice's column block of each batch (a batch the data axis
does not divide is padded with masked slots).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Collectives wait at most this long for a peer (process group timeout).
DEFAULT_TIMEOUT = timedelta(seconds=300)


def choose_backend(world_size: int, device_type: str) -> str:
    """NCCL where each of ``world_size`` ranks can have a card of its own,
    else gloo (the CPU, or ranks sharing a card: NCCL refuses two ranks on
    one device)."""
    if (device_type == "cuda" and dist.is_nccl_available()
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % cards)`` or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def local_device(device_type: Optional[str] = None) -> torch.device:
    """This process's device: its current card (``initialize`` and
    ``spawn`` set it from the rank), or the CPU. ``device_type`` defaults
    to the card where one is visible."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _init_group(backend: str, init_method: str, world_size: int, rank: int,
                device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(rank, device_type))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=DEFAULT_TIMEOUT)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               device_type: str = "cuda") -> None:
    """Make this process rank ``process_id`` of ``num_processes``, meeting
    the others at ``coordinator_address`` (host:port; rank 0 listens
    there). A no-op without a coordinator and a process count (one
    process, as in the JAX package), or when a group exists already."""
    if dist.is_initialized() or (coordinator_address is None and num_processes is None):
        return
    if not coordinator_address or not num_processes or num_processes < 1 \
            or process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(
            "a multi-process run needs --coordinator host:port, --num_processes P >= 1 and "
            f"--process_id in [0, P); got {coordinator_address!r}, {num_processes}, "
            f"{process_id}")
    _init_group(choose_backend(num_processes, device_type), f"tcp://{coordinator_address}",
                num_processes, process_id, device_type)


def process_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the one rank that writes the run directory (checkpoints,
    metrics, summaries, pickles); every rank of a single process is."""
    return process_info()[0] == 0


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (itself without a process group)."""
    if process_info()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if process_info()[1] > 1:
        dist.barrier()


def host_local_starts(all_starts, data_shards: int, data_index: Optional[int] = None):
    """This rank's column block of a (n_batches, bs) epoch array: data slice
    ``data_index`` of ``data_shards`` (default: this process's, the ranks
    of a data slice being consecutive as in ``mesh.rank_grid``). A batch
    that ``data_shards`` does not divide is padded with zero columns to
    ``ceil(bs / data_shards) * data_shards``, so that every rank runs the
    same shapes and the blocks side by side are the single-device layout
    followed by slots that start at 0 and are masked out."""
    if data_index is None:
        pid, pcount = process_info()
        if pcount == 1:
            return all_starts
        data_index = pid // (pcount // data_shards)
    if data_shards == 1:
        return all_starts
    bs = all_starts.shape[1]
    per = -(-bs // data_shards)
    local = all_starts[:, min(data_index * per, bs):(data_index + 1) * per]
    short = per - local.shape[1]
    if short == 0:
        return local
    if isinstance(local, torch.Tensor):
        return torch.cat([local, local.new_zeros((local.shape[0], short))], dim=1)
    return np.pad(local, ((0, 0), (0, short)))


def epoch_arrays(mesh, starts, mask):
    """This rank's (starts, mask) of a (n_batches, bs) epoch: every rank
    computes the same seeded arrays and keeps its data slice's columns
    (``host_local_starts``: padded slots have mask 0). Without a mesh, or
    with one data slice, the arrays themselves."""
    if mesh is None or mesh.dp == 1:
        return starts, mask
    return (host_local_starts(starts, mesh.dp, mesh.data_index),
            host_local_starts(mask, mesh.dp, mesh.data_index))


def _rank_entry(rank: int, world_size: int, init_method: str, device_type: str,
                result_path: str, fn: Callable, args: Sequence) -> None:
    if device_type == "cpu":
        # the ranks share this host's threads (OMP_NUM_THREADS, else its cores)
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    _init_group(choose_backend(world_size, device_type), init_method, world_size, rank,
                device_type)
    try:
        with contextlib.ExitStack() as stack:
            if rank:
                # every rank prints the same lines; rank 0's are the run's
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            out = fn(*args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(n: int, fn: Callable, args: Sequence = (), device_type: str = "cpu",
          deadline: Optional[float] = None) -> Any:
    """Run ``fn(*args)`` in ``n`` new local ranks of one process group (gloo
    or NCCL, ``choose_backend``; rank r on ``rank_device(r, device_type)``)
    and return rank 0's result. ``fn`` must be importable by name (the
    ranks start from a fresh interpreter). A rank that raises ends the
    others and raises here; past ``deadline`` seconds the ranks are killed
    and ``TimeoutError`` raised. The standard output of ranks other than 0
    is silenced."""
    import torch.multiprocessing as tmp

    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    with tempfile.TemporaryDirectory(prefix="mesh_") as work:
        result = os.path.join(work, "result.pkl")
        ctx = tmp.start_processes(
            _rank_entry, nprocs=n, start_method="spawn", join=False,
            args=(n, f"file://{os.path.join(work, 'rendezvous')}", device_type, result, fn,
                  tuple(args)))
        end = None if deadline is None else time.monotonic() + deadline
        try:
            while not ctx.join(timeout=1.0):
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} still "
                                       f"running after {deadline} s: killed")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        with open(result, "rb") as f:
            return pickle.load(f)


def run_mesh(fn: Callable, args: Sequence, mesh_devices: int, coordinator: str,
             num_processes: int, process_id: int, device: torch.device) -> Any:
    """The entry points' launcher: ``fn(*args)`` as this process's rank of
    a group started elsewhere when a coordinator or a process count is
    given (``--mesh_devices`` then P or -1), else in ``mesh_devices``
    spawned local ranks (-1: every visible card). ``fn`` builds its mesh
    (``mesh.make_mesh``) and returns what rank 0's returns."""
    device = torch.device(device)
    if coordinator or num_processes > 0:
        if mesh_devices not in (num_processes, -1):
            raise ValueError(f"--mesh_devices {mesh_devices} beside --num_processes "
                             f"{num_processes}: one rank is one device, so the mesh is "
                             "every process (give P or -1)")
        initialize(coordinator or None, num_processes or None,
                   None if process_id < 0 else process_id, device.type)
        return fn(*args)
    if mesh_devices < 0:
        if device.type != "cuda":
            raise ValueError("--mesh_devices -1 takes every visible card; on the CPU give "
                             "the number of ranks")
        mesh_devices = torch.cuda.device_count()
    print(f"Spawning {mesh_devices} ranks ({choose_backend(mesh_devices, device.type)}) "
          f"on {device.type}", file=sys.stderr)
    return spawn(mesh_devices, fn, args, device_type=device.type)

