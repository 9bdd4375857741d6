"""Rank functions of the mesh tests, in a module that imports no JAX: every
spawned rank imports the module its function lives in, and a test module
would bring JAX and the JAX package into each rank."""

import torch
import torch.distributed as dist

from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.inference import Predictor
from mtad_gat_tpu_torch.nn.gat import TemporalAttention
from mtad_gat_tpu_torch.parallel import banded_halo_attention, make_mesh, multihost, use_mesh
from mtad_gat_tpu_torch.parallel.ring_attention import ring_gatv2_attention
from mtad_gat_tpu_torch.parallel.sharding import all_reduce_
from mtad_gat_tpu_torch.training import MultiEntityTrainer, Trainer


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


def scores_of(model, series, window, batch_size, mesh=None):
    """The forecasts and last-step reconstructions of every window of
    ``series``, scored at ``batch_size`` (over ``mesh`` when given)."""
    args = dict(dataset="SMD", target_dims=None, scale_scores=False, q=1e-3, level=0.99,
                dynamic_pot=False, use_mov_av=False, gamma=1.0, reg_level=1, save_path="")
    predictor = Predictor(model, window, series.shape[1], args, batch_size=batch_size,
                          mesh=mesh)
    return predictor._score_pass(series, len(series) - window + 1)


def trainer_rank(model_kw, train_kw, state_dict, series, starts, mask, log_dir,
                 model_parallel):
    """Each rank: one step's gradients, 2 epochs' losses and parameters at
    dropout 0 and the trained model's scores at the training batch, then an
    epoch at dropout 0.3 (its first step's generator seed, its parameters)
    on a mesh with a model axis, without and with ``remat_attention``; rank
    0 returns every rank's."""
    torch.set_num_threads(1)
    mesh = make_mesh(model_parallel=model_parallel, device="cpu")
    trainer = Trainer(MTADGATConfig(**model_kw), TrainConfig(**train_kw), log_dir=log_dir,
                      device="cpu", mesh=mesh)
    trainer.init_state()
    trainer.model.load_state_dict(state_dict)
    grads = step_grads(trainer, series, starts, mask)
    trainer.fit(series)
    mine = dict(rank=mesh.rank, data_index=mesh.data_index, grads=grads,
                losses=trainer.losses, params=params_of(trainer.model),
                scores=scores_of(trainer.model, series, model_kw["window_size"],
                                 train_kw["bs"], mesh))
    if mesh.mp > 1:
        for remat in (False, True):
            dropped = Trainer(MTADGATConfig(**dict(model_kw, dropout=0.3,
                                                   remat_attention=remat)),
                              TrainConfig(**dict(train_kw, epochs=1)), log_dir=log_dir,
                              device="cpu", mesh=mesh)
            dropped.init_state()
            dropped.model.load_state_dict(state_dict)
            mine["seed"] = dropped.step_generator().initial_seed()
            dropped.fit(series)
            key = "dropped_remat" if remat else "dropped"
            mine.update({key: params_of(dropped.model), f"{key}_losses": dropped.losses})
    return _every_rank(mine)


def halo_layer(case, impl="ring"):
    """The temporal attention of a halo test case, with its weights."""
    layer = TemporalAttention(case["x"].shape[2], case["n"], dropout=0.0, alpha=0.2,
                              use_gatv2=case["gatv2"], impl=impl,
                              graph_spec=f"band:{case['w']}", bias_storage=case["storage"])
    layer.load_state_dict({k: torch.tensor(v) for k, v in case["state"].items()})
    return layer


def layer_result(layer, case, mesh=None):
    """A layer's output on the case's input under ``mesh`` and the gradients
    of sum(out * cot): the input's, and every parameter's summed over the
    model axis where they are each rank's part (``partial_grads``), as the
    trainer sums them; and the layer's routes under the mesh."""
    x = torch.from_numpy(case["x"]).requires_grad_()
    with use_mesh(mesh):
        out = layer(x)
    (out * torch.from_numpy(case["cot"])).sum().backward()
    grads = {k: p.grad for k, p in layer.named_parameters()}
    if layer.partial_grads(mesh):
        for g in grads.values():
            all_reduce_(g, mesh.model_group)
    return dict(out=out.detach().numpy(), dx=x.grad.numpy(),
                grads={k: g.numpy() for k, g in grads.items()},
                halos=layer.halos(mesh), partial=layer.partial_grads(mesh))


def halo_rank(layer_cases, drop_cases, rate, seed, trainer_args):
    """Each of 4 ranks, on a (model 4) and a (data 2, model 2) mesh: every
    layer case's ``layer_result`` through ``attention_impl="ring"``, and
    every dropout case's ``banded_halo_attention`` at ``rate``; then the
    ``Trainer`` of ``trainer_args`` on the (data 2, model 2) mesh: one
    epoch's per-batch losses and its parameters, and the same at dropout 0.3
    without and with ``remat_attention``. Rank 0 returns every rank's."""
    torch.set_num_threads(1)
    meshes = {4: make_mesh(model_parallel=4, device="cpu"),
              2: make_mesh(model_parallel=2, device="cpu")}
    mine = {"layers": {}, "dropped": {}}
    for shards, mesh in meshes.items():
        mine["layers"][shards] = [layer_result(halo_layer(c), c, mesh) for c in layer_cases]
        mine["dropped"][shards] = [
            banded_halo_attention(*(None if c[k] is None else torch.from_numpy(c[k])
                                    for k in ("p", "q", "a", "bias", "v")),
                                  0.2, c["w"], mesh, rate, seed).numpy()
            for c in drop_cases]
    model_kw, train_kw, state_dict, series, starts, mask, log_dir = trainer_args
    trainer = Trainer(MTADGATConfig(**model_kw), TrainConfig(**train_kw), log_dir=log_dir,
                      device="cpu", mesh=meshes[2])
    trainer.init_state()
    trainer.model.load_state_dict(state_dict)
    f, r = trainer.train_epoch(torch.from_numpy(series), starts, mask)
    mine["trainer"] = dict(f=f, r=r, params=params_of(trainer.model),
                           halos=trainer.model.temporal_gat.halos(meshes[2]))
    for remat in (False, True):
        dropped = Trainer(MTADGATConfig(**dict(model_kw, dropout=0.3, remat_attention=remat)),
                          TrainConfig(**train_kw), log_dir=log_dir, device="cpu",
                          mesh=meshes[2])
        dropped.init_state()
        dropped.model.load_state_dict(state_dict)
        f, r = dropped.train_epoch(torch.from_numpy(series), starts, mask)
        mine["remat" if remat else "dropped_trainer"] = dict(f=f, r=r,
                                                             params=params_of(dropped.model))
    return _every_rank(mine)


def fleet_of(mesh, model_kw, train_kw, series, dropout, save_path="", resume_from=None):
    """A ``MultiEntityTrainer`` over ``mesh`` (None: one device) fitted on
    ``series`` (from a saved fleet state when ``resume_from``): every
    entity's losses, parameters and steps, and this rank's fleet steps."""
    mt = MultiEntityTrainer(MTADGATConfig(**model_kw, dropout=dropout), TrainConfig(**train_kw),
                            device="cpu", mesh=mesh, save_path=save_path)
    if resume_from:
        mt.load_fleet(resume_from, len(series))
    mt.fit(series, verbose=False)
    return dict(losses=mt.losses, steps=mt.steps.tolist(), fleet_steps=mt.fleet_steps,
                params=[{k: v.numpy() for k, v in mt.entity_params(e).items()}
                        for e in range(len(series))])


def fleet_rank(model_kw, train_kw, series, small, save_dir, resume_from):
    """Each rank of a fleet mesh (model axis 1): the fleet at dropout 0.2
    and at dropout 0; with ``small`` that fleet at dropout 0.2; with
    ``save_dir`` one epoch, its state written there; with ``resume_from``
    the fleet at dropout 0.2 resumed from that state. Rank 0 returns every
    rank's."""
    torch.set_num_threads(1)
    mesh = make_mesh(model_parallel=1, device="cpu")
    mine = {"rank": mesh.rank,
            "dropout": fleet_of(mesh, model_kw, train_kw, series, 0.2),
            "nodrop": fleet_of(mesh, model_kw, train_kw, series, 0.0)}
    if small is not None:
        mine["small"] = fleet_of(mesh, model_kw, train_kw, small, 0.2)
    if save_dir:
        fleet_of(mesh, model_kw, dict(train_kw, epochs=1, checkpoint_every=1), series, 0.2,
                 save_path=save_dir)
    if resume_from:
        mine["resumed"] = fleet_of(mesh, model_kw, train_kw, series, 0.2,
                                   resume_from=resume_from)
    return _every_rank(mine)


def fail_on_last_rank():
    """Rank world - 1 raises; the others return."""
    if dist.get_rank() == dist.get_world_size() - 1:
        raise RuntimeError("this rank fails")


def hang():
    """Every rank waits far beyond any test's deadline."""
    import time

    time.sleep(600)
