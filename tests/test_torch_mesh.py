"""The port's mesh layout and data feeding against the JAX package's.

- ``best_mesh_shape`` equals JAX's for 1-16 devices, with the default
  factorization and with every model axis that divides the count.
- The (data, model) grid of ranks (``rank_grid``, the mesh's ``devices``)
  equals the ids of JAX's ``make_mesh(...).devices`` on the 8-device CPU
  farm, and each rank's data and model index its place in it.
- ``host_local_starts`` and ``is_primary`` as ``tests/test_multihost.py``
  holds JAX's (process info monkeypatched): each rank keeps its column
  block, the blocks tile the batch, with a data slice of several model
  ranks too; a batch the data axis does not divide is padded with zero
  columns (masked out in ``epoch_arrays``), so the blocks side by side are
  the single-device layout followed by them.
- Without a process group: a one-rank mesh, every collective the
  identity, ``use_mesh`` / ``current_mesh`` and ``constrain`` as JAX's.
- ``multihost.spawn``: a rank that raises makes it raise, and ranks past
  the deadline are killed and it raises ``TimeoutError``.
"""

import time


import jax
import numpy as np
import pytest
import torch

import mtad_gat_tpu_torch.parallel.multihost as mh
from mtad_gat_tpu.parallel import best_mesh_shape as jax_best_mesh_shape
from mtad_gat_tpu.parallel import make_mesh as jax_make_mesh
from mtad_gat_tpu_torch.parallel import (best_mesh_shape, constrain, current_mesh, make_mesh,
                                         use_mesh)
from mtad_gat_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, rank_grid
from mtad_gat_tpu_torch.parallel.sharding import (copy_to_model, data_sum, gather_model,
                                                  ppermute)
from tests.torch_mesh_ranks import fail_on_last_rank, hang

torch.set_num_threads(1)


@pytest.mark.parametrize("n", range(1, 17))
def test_best_mesh_shape_is_jaxs(n):
    assert best_mesh_shape(n) == jax_best_mesh_shape(n)
    for mp in range(1, n + 1):
        if n % mp == 0:
            assert best_mesh_shape(n, mp) == jax_best_mesh_shape(n, model_parallel=mp)
        else:
            with pytest.raises(ValueError, match="does not divide"):
                best_mesh_shape(n, mp)


@pytest.mark.parametrize("n,mp", [(1, None), (2, None), (2, 1), (4, None), (4, 2), (6, 2),
                                  (8, None), (8, 2), (8, 4), (8, 8)])
def test_rank_grid_is_jaxs_device_grid(n, mp):
    want = np.vectorize(lambda d: d.id)(jax_make_mesh(n, model_parallel=mp).devices)
    grid = rank_grid(n, mp)
    np.testing.assert_array_equal(grid, want)
    for rank in range(n):
        mesh = Mesh(grid, rank, torch.device("cpu"))
        assert (mesh.data_index, mesh.model_index) == (rank // grid.shape[1],
                                                       rank % grid.shape[1])
        assert mesh.shape == {DATA_AXIS: grid.shape[0], MODEL_AXIS: grid.shape[1]}
        assert grid[mesh.data_index, mesh.model_index] == rank


def test_host_local_starts_single_process():
    starts = np.arange(12).reshape(3, 4)
    np.testing.assert_array_equal(mh.host_local_starts(starts, 1), starts)
    assert mh.process_info() == (0, 1) and mh.is_primary()


def test_host_local_starts_multi_process_slicing(monkeypatch):
    starts = np.arange(24).reshape(3, 8)
    seen = []
    for pid in range(4):
        monkeypatch.setattr(mh, "process_info", lambda pid=pid: (pid, 4))
        assert mh.is_primary() == (pid == 0)
        local = mh.host_local_starts(starts, 4)
        assert local.shape == (3, 2)
        np.testing.assert_array_equal(local, starts[:, pid * 2:(pid + 1) * 2])
        seen.append(local)
    np.testing.assert_array_equal(np.concatenate(seen, axis=1), starts)

    # two model ranks a data slice: ranks 2 and 3 hold slice 1
    monkeypatch.setattr(mh, "process_info", lambda: (3, 4))
    np.testing.assert_array_equal(mh.host_local_starts(starts, 2), starts[:, 4:])

    # five processes, eight columns: blocks of two, the last all padding
    blocks = []
    for pid in range(5):
        monkeypatch.setattr(mh, "process_info", lambda pid=pid: (pid, 5))
        blocks.append(mh.host_local_starts(starts, 5))
        assert blocks[-1].shape == (3, 2)
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1),
                                  np.pad(starts, ((0, 0), (0, 2))))


def test_epoch_arrays_keep_the_data_slice():
    starts = torch.arange(16).reshape(2, 8)
    mask = torch.ones(2, 8)
    assert mh.epoch_arrays(None, starts, mask) == (starts, mask)
    grid = rank_grid(4, 2)
    for rank in range(4):
        mesh = Mesh(grid, rank, torch.device("cpu"))
        s, m = mh.epoch_arrays(mesh, starts, mask)
        d = rank // 2
        assert torch.equal(s, starts[:, d * 4:(d + 1) * 4]) and m.shape == (2, 4)
    # three data slices of eight columns: blocks of three, the padded slot
    # starting at 0 and masked out, so the blocks side by side are the
    # single-device layout followed by it
    blocks = [mh.epoch_arrays(Mesh(rank_grid(3, 1), r, torch.device("cpu")), starts, mask)
              for r in range(3)]
    assert all(s.shape == m.shape == (2, 3) for s, m in blocks)
    assert torch.equal(torch.cat([s for s, _ in blocks], dim=1)[:, :8], starts)
    assert torch.equal(torch.cat([m for _, m in blocks], dim=1),
                       torch.cat([mask, torch.zeros(2, 1)], dim=1))
    assert torch.equal(blocks[2][0][:, 2], torch.zeros(2, dtype=starts.dtype))


def test_one_rank_mesh_without_a_process_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.dp, mesh.mp, mesh.rank) == (1, 1, 0)
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="initialized process group"):
        make_mesh(2, device="cpu")
    x = torch.randn(2, 3, 4, requires_grad=True)
    for f in (data_sum, copy_to_model, gather_model, ppermute):
        assert f(x, mesh) is x
        assert f(x, None) is x


def test_use_mesh_and_constrain():
    assert current_mesh() is None
    mesh = make_mesh(device="cpu")
    with use_mesh(mesh):
        assert current_mesh() is mesh
        with use_mesh(None):
            assert current_mesh() is None
        assert current_mesh() is mesh
    assert current_mesh() is None
    x = torch.ones(4, 4)
    assert constrain(x, "data", None) is x
    assert len(jax.devices()) >= 8   # the JAX side's farm the grid tests read


def test_spawn_fails_with_a_rank_and_past_the_deadline(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(Exception, match="this rank fails"):
        mh.spawn(2, fail_on_last_rank, deadline=60.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="killed"):
        mh.spawn(2, hang, deadline=3.0)
    assert time.monotonic() - t0 < 60.0
