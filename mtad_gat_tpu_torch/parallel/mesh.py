"""Device mesh over ``torch.distributed`` ranks.

The port of ``mtad_gat_tpu/parallel/mesh.py``. One rank is one process and
one device. The ranks form a (data, model) grid as JAX's
``np.asarray(devices).reshape(dp, mp)`` does: rank r sits at data index
``r // mp`` and model index ``r % mp``. The data axis splits a batch's
windows; the model axis splits the attention's node axis under
``attention_impl="ring"`` (``parallel/ring_attention.py``). Each axis has
its process groups: rank r's data group holds the ranks of its model index
(one rank a data slice), its model group the ranks of its data index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mtad_gat_tpu_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"


def best_mesh_shape(n_devices: int, model_parallel: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) factorization, JAX's: the given model axis, or a
    balanced split with the model axis a power of two up to 4."""
    if model_parallel is not None:
        if model_parallel < 1 or n_devices % model_parallel:
            raise ValueError(f"model_parallel {model_parallel} does not divide "
                             f"{n_devices} devices")
        return n_devices // model_parallel, model_parallel
    if n_devices == 1:
        return 1, 1
    mp = 1
    while mp * 2 <= n_devices and n_devices % (mp * 2) == 0 and mp < 4:
        mp *= 2
    return n_devices // mp, mp


def rank_grid(n_devices: int, model_parallel: Optional[int] = None) -> np.ndarray:
    """The ranks as a (data, model) array: row d holds data slice d's model
    ranks."""
    dp, mp = best_mesh_shape(n_devices, model_parallel)
    return np.arange(n_devices).reshape(dp, mp)


class Mesh:
    """This rank's place in a (data, model) grid of ranks and the process
    groups of its two axes (None where an axis has one rank, so that the
    collectives of ``parallel/sharding.py`` skip it).

    ``shape`` reads as a JAX mesh's; ``devices`` is the grid of ranks;
    ``device`` is this rank's device and ``rank_devices`` every rank's, in
    rank order; ``backend`` the process group's (None without one)."""

    def __init__(self, grid: np.ndarray, rank: int, device: torch.device,
                 backend: Optional[str] = None, rank_devices: Tuple[str, ...] = ()):
        self.devices = grid
        self.dp, self.mp = grid.shape
        self.rank = rank
        self.data_index, self.model_index = (int(i[0]) for i in np.nonzero(grid == rank))
        self.device = torch.device(device)
        self.backend = backend
        self.data_group = self.model_group = None
        self.rank_devices = tuple(rank_devices) or (str(self.device),)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    def describe(self) -> str:
        return (f"Mesh {self.shape} over {self.size} ranks, backend {self.backend or 'none'}"
                f"{' (collectives through host memory)' if self.host_staged() else ''}, "
                f"rank devices {list(self.rank_devices)}")

    def host_staged(self) -> bool:
        """Whether collectives on this rank's CUDA tensors go through host
        memory: gloo between ranks on the card."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(n_devices: Optional[int] = None, model_parallel: Optional[int] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """The mesh of all ``n_devices`` ranks of the initialized process group
    (default: its world size), its model axis ``model_parallel`` or JAX's
    factorization. Every rank calls it, in the same order as its other
    group creations: it creates every data and model group. Without a
    process group only a one-rank mesh exists. ``device`` defaults to the
    rank's (``multihost.local_device``). Each group's collectives time out
    after ``multihost.DEFAULT_TIMEOUT``."""
    device = multihost.local_device() if device is None else torch.device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs an initialized process group "
                             "(parallel/multihost.initialize or spawn)")
        return Mesh(rank_grid(1, model_parallel), 0, device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}: one rank is "
                         "one device, so the mesh holds every rank")
    grid = rank_grid(n, model_parallel)
    timeout = multihost.DEFAULT_TIMEOUT
    data_groups = [dist.new_group(grid[:, m].tolist(), timeout=timeout)
                   for m in range(grid.shape[1])]
    model_groups = [dist.new_group(grid[d].tolist(), timeout=timeout)
                    for d in range(grid.shape[0])]
    rank = dist.get_rank()
    names = [None] * world
    dist.all_gather_object(names, str(device))
    mesh = Mesh(grid, rank, device, dist.get_backend(), rank_devices=names)
    mesh.data_group = data_groups[mesh.model_index] if mesh.dp > 1 else None
    mesh.model_group = model_groups[mesh.data_index] if mesh.mp > 1 else None
    return mesh
