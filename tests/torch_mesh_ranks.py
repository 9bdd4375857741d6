"""Rank functions of the mesh tests, in a module that imports no JAX: every
spawned rank imports the module its function lives in, and a test module
would bring JAX and the JAX package into each rank."""

import torch
import torch.distributed as dist

from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.parallel import make_mesh, multihost
from mtad_gat_tpu_torch.parallel.ring_attention import ring_gatv2_attention
from mtad_gat_tpu_torch.parallel.sharding import all_reduce_
from mtad_gat_tpu_torch.training import Trainer


def _every_rank(mine):
    """Every rank's ``mine``, in rank order."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def ring_rank(cases, alpha, rate, seed):
    """Each rank: the ring's output and gradients of every case, the
    gradients summed over the model axis, and its output at dropout 0.3;
    rank 0 returns every rank's."""
    torch.set_num_threads(1)
    mesh = make_mesh(model_parallel=dist.get_world_size(), device="cpu")
    results = []
    for c in cases:
        names = [k for k in ("p", "q", "a", "bias", "v") if c[k] is not None]
        leaves = {k: torch.from_numpy(c[k]).requires_grad_() for k in names}
        args = [leaves.get(k) for k in ("p", "q", "a", "bias", "v")]
        out = ring_gatv2_attention(*args, alpha, mesh)
        (out * torch.from_numpy(c["cot"])).sum().backward()
        grads = {k: all_reduce_(leaves[k].grad, mesh.model_group).numpy() for k in names}
        with torch.no_grad():
            dropped = ring_gatv2_attention(*args, alpha, mesh, dropout_rate=rate,
                                           dropout_seed=seed)
        results.append((out.detach().numpy(), grads, dropped.numpy()))
    return _every_rank(results)


def step_grads(trainer, series, starts, mask):
    """One step's gradients on this rank's columns of the (1, bs) batch,
    summed over the mesh."""
    starts, mask = multihost.epoch_arrays(trainer.mesh, starts, mask)
    trainer.step_gradients(torch.from_numpy(series), starts[0], mask[0],
                           trainer.step_generator())
    grads = {k: p.grad.clone().numpy() for k, p in trainer.model.named_parameters()}
    trainer.optimizer.zero_grad(set_to_none=True)
    return grads


def params_of(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def trainer_rank(model_kw, train_kw, state_dict, series, starts, mask, log_dir,
                 model_parallel):
    """Each rank: one step's gradients, 2 epochs' losses and parameters at
    dropout 0, then an epoch at dropout 0.3 (its first step's generator
    seed, its parameters) on a mesh with a model axis; rank 0 returns every
    rank's."""
    torch.set_num_threads(1)
    mesh = make_mesh(model_parallel=model_parallel, device="cpu")
    trainer = Trainer(MTADGATConfig(**model_kw), TrainConfig(**train_kw), log_dir=log_dir,
                      device="cpu", mesh=mesh)
    trainer.init_state()
    trainer.model.load_state_dict(state_dict)
    grads = step_grads(trainer, series, starts, mask)
    trainer.fit(series)
    mine = dict(rank=mesh.rank, data_index=mesh.data_index, grads=grads,
                losses=trainer.losses, params=params_of(trainer.model))
    if mesh.mp > 1:
        dropped = Trainer(MTADGATConfig(**dict(model_kw, dropout=0.3)),
                          TrainConfig(**dict(train_kw, epochs=1)), log_dir=log_dir,
                          device="cpu", mesh=mesh)
        dropped.init_state()
        dropped.model.load_state_dict(state_dict)
        mine["seed"] = dropped.step_generator().initial_seed()
        dropped.fit(series)
        mine.update(dropped=params_of(dropped.model), dropped_losses=dropped.losses)
    return _every_rank(mine)


def fail_on_last_rank():
    """Rank world - 1 raises; the others return."""
    if dist.get_rank() == dist.get_world_size() - 1:
        raise RuntimeError("this rank fails")


def hang():
    """Every rank waits far beyond any test's deadline."""
    import time

    time.sleep(600)
