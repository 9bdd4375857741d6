"""Fleet training: E same-shape entities trained in one vmapped step.

The port of ``mtad_gat_tpu/training/multi_entity.py``. The JAX trainer runs
``jax.vmap(entity_step)`` over parameters stacked on a leading entity axis;
here one model runs over the stacked parameters as
``torch.func.vmap(grad_and_value(loss))``, the loss ``make_loss_fn``'s
through ``functional_call``. Under that vmap the GRU's forward and backward
are custom ops whose vmap rules launch K3, K4's scan and K4's weights
product once each for all entities (``kernels/_vmap.py``), so a fleet step
launches two of each (encoder and decoder) whatever E is. The attention
runs the dense path, or with ``attention_impl="pallas"`` (and where the
dense route sends a layer to the kernels) K1-res forward (whole-graph or
tiled) and K2ab, the tiled K2a and K2b (any tile) or the streamed
backward, each one grouped launch a layer for all entities, each entity's
hash mask keyed by its own seed. A band graph wider than the unrolled
cutoff runs the block scan under the vmap, each entity's mask keyed by its
own seed there too.

Entity e's trajectory is its solo ``Trainer``'s to float tolerance:

- the same init (one seed for every entity, as the sequential sweep does);
- the same split and shuffles, each entity drawing from its own
  ``np.random.default_rng(seed)`` in ``Trainer.fit``'s order;
- the same dropout masks: at every step each entity's masks, and the
  attention kernels' hash seeds, come from a generator seeded
  ``step_seed(seed, step_e)`` at its own step, drawn in the solo forward's
  order (``graph/dropout.EntityGenerators``);
- Adam by ``torch.optim.Adam``'s formula with per-entity steps and bias
  corrections, global-norm clipping over each entity's own gradients and the
  learning rate of its own step;
- padded batches (entities differ in length, so in batch counts) leave an
  entity's parameters, moments and step untouched: the masked RMSE's
  gradient at an all-zero mask is NaN, so the update is gated by
  ``torch.where``, never multiplied by the mask.

The series go to the device once per ``fit``, an epoch's schedule and its
per-entity step scalars once per epoch, and the losses come back once per
epoch.

``train_config.profile_dir`` traces nothing here, as in the JAX fleet
trainer: the solo ``Trainer`` and the sequential sweep trace.

On a mesh (``mesh=``, one rank a process and a device), the entity axis is
split over the data axis, as the JAX trainer shards it: data rank d trains
the d-th of ``entity_blocks``' contiguous blocks (sizes differing by at
most one, so 28 entities over 3 ranks train 10, 9 and 9) with no
collective inside a step, each rank on its own block's schedule (all-masked
steps are no-ops, so the ranks need no lockstep within an epoch). At each
epoch's end the losses are gathered over the data axis, and after ``fit``
the trained blocks, so that ``losses`` and ``entity_params`` cover every
entity on every rank. ``fleet_state.pt`` keeps its one-device format: the
primary writes the gathered blocks, and a state written on any number of
ranks resumes on any other. A rank with no entity (fewer entities than
data ranks) joins the collectives and takes no step.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import grad_and_value, vmap

from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.data.windows import batched_starts, num_windows
from mtad_gat_tpu_torch.graph.dropout import EntityGenerators
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from mtad_gat_tpu_torch.training.trainer import learning_rate, make_loss_fn, step_seed
from mtad_gat_tpu_torch.utils.weights import Stacked, stack_state_dicts, unstack_state_dict

# torch.optim.Adam's defaults, as the solo Trainer uses them
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def entity_blocks(n_entities: int, n_ranks: int) -> List[Tuple[int, int]]:
    """Each of ``n_ranks`` data ranks' (first, end) entities: contiguous
    blocks in global order whose sizes differ by at most one, the larger
    first (28 over 3: 10, 9, 9); empty where ranks outnumber entities."""
    base, extra = divmod(n_entities, n_ranks)
    ends = np.cumsum([base + (r < extra) for r in range(n_ranks)])
    return [(int(e - base - (r < extra)), int(e)) for r, e in enumerate(ends)]


def _per_entity(values, like: torch.Tensor) -> torch.Tensor:
    """(E,) values shaped to broadcast against an (E, ...) tensor."""
    return values.reshape(-1, *([1] * (like.dim() - 1)))


class MultiEntityTrainer:
    """Train E same-shape entities in lockstep on ``device``. Series may
    differ in length; schedules are padded per entity and masked exactly.

    ``params`` holds the stacked weights (name -> (E, ...) on the device),
    ``exp_avg`` / ``exp_avg_sq`` Adam's moments alike, ``steps`` the
    entities' optimizer steps (a host int64 array: it seeds their dropout
    and picks their learning rates), ``losses`` one dict of the six loss
    series an entity. Outside ``fit`` they hold every entity; inside it, on
    a mesh, this rank's block (module docstring).
    """

    FLEET_STATE_FILE = "fleet_state.pt"

    def __init__(
        self,
        model_config: MTADGATConfig,
        train_config: TrainConfig,
        target_dims: Optional[Sequence[int]] = None,
        horizon: int = 1,
        save_path: str = "",
        device: str = "cuda",
        mesh=None,
    ):
        learning_rate(train_config, 0)   # an unknown schedule raises here
        self.model_config = model_config
        self.train_config = train_config
        self.target_dims = None if target_dims is None else tuple(target_dims)
        self.horizon = horizon
        self.window = model_config.window_size
        self.save_path = save_path
        self.device = torch.device(device)
        # the entity axis over this mesh's data axis (module docstring)
        self.mesh = mesh
        # whether the state is this rank's block (inside fit on a mesh)
        self._blockwise = False
        # the module the stacked weights run through; its own are not used
        self.model = MTADGAT(model_config).to(self.device)
        self._loss_fn = make_loss_fn(self.model, self.window, horizon, self.target_dims)
        self.params: Optional[Stacked] = None
        self.exp_avg: Optional[Stacked] = None
        self.exp_avg_sq: Optional[Stacked] = None
        self.steps: Optional[np.ndarray] = None
        self.losses: Optional[List[Dict[str, List[float]]]] = None
        # (n_batches, E) forecast and recon RMSEs of the last trained epoch,
        # NaN where an entity had no batch
        self.last_batch_losses: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # fleet steps run by train_epoch (each one vmapped step for all)
        self.fleet_steps = 0

        def entity_loss(params, series, starts, mask, generator):
            total, (f, r) = self._loss_fn(series, starts, mask, generator, False, params)
            return total, (f, r)

        # randomness stays "error": every draw goes through EntityGenerators
        self._grad = vmap(grad_and_value(entity_loss, has_aux=True),
                          in_dims=(0, 0, 0, 0, None))
        self._eval = vmap(lambda p, s, st, m: self._loss_fn(s, st, m, None, True, p)[1])

    # ------------------------------------------------------------------
    def init_states(self, n_entities: int, seed: Optional[int] = None) -> None:
        """Every entity from one seed, as the sequential sweep (each solo
        run seeds its model with the train seed), Adam's moments zero,
        steps 0."""
        seed = self.train_config.seed if seed is None else seed
        model = MTADGAT(self.model_config, generator=torch.Generator().manual_seed(seed))
        self.set_states([model.state_dict()] * n_entities)

    def set_states(self, state_dicts: Sequence[Dict[str, torch.Tensor]]) -> None:
        """Start from these E ``state_dict``s (``stack_state_dicts``), each
        entity's Adam moments zero and step 0."""
        names = [n for n, _ in self.model.named_parameters()]
        stacked = stack_state_dicts(state_dicts)
        if sorted(stacked) != sorted(names):
            raise ValueError(f"state_dicts hold {sorted(stacked)}, the model {sorted(names)}")
        self.params = {n: stacked[n].to(self.device) for n in names}
        self.exp_avg = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.exp_avg_sq = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.steps = np.zeros(len(state_dicts), np.int64)

    @property
    def n_entities(self) -> int:
        return 0 if self.steps is None else len(self.steps)

    def entity_params(self, e: int) -> Dict[str, torch.Tensor]:
        """Entity e's trained weights as a port ``state_dict`` (CPU)."""
        return unstack_state_dict(self.params, e)

    def _data_group(self):
        return None if self.mesh is None else self.mesh.data_group

    def _gathered(self, mine) -> list:
        """Every data rank's ``mine`` in data-rank order (``[mine]`` without
        a data axis): the fleet's host-side gathers, once an epoch."""
        group = self._data_group()
        if group is None:
            return [mine]
        every = [None] * dist.get_world_size(group)
        dist.all_gather_object(every, mine, group=group)
        return every

    def _narrow(self, first: int, end: int) -> None:
        """Keep entities first .. end - 1 of the state (this rank's block)."""
        for name in ("params", "exp_avg", "exp_avg_sq"):
            setattr(self, name, {n: p[first:end] for n, p in getattr(self, name).items()})
        self.steps = self.steps[first:end]

    def _state(self) -> dict:
        """The whole fleet's state on the host: this rank's block gathered
        with the others' in entity order inside ``fit`` on a mesh (every
        rank must call it then), else the state itself."""
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
        mine = {"params": cpu(self.params), "exp_avg": cpu(self.exp_avg),
                "exp_avg_sq": cpu(self.exp_avg_sq), "steps": torch.from_numpy(self.steps)}
        if not self._blockwise:
            return mine
        blocks = self._gathered(mine)
        return {"params": {n: torch.cat([b["params"][n] for b in blocks]) for n in mine["params"]},
                **{k: {n: torch.cat([b[k][n] for b in blocks]) for n in mine[k]}
                   for k in ("exp_avg", "exp_avg_sq")},
                "steps": torch.cat([b["steps"] for b in blocks])}

    def _restore(self, state: dict) -> None:
        dev = lambda d: {k: v.to(self.device) for k, v in d.items()}  # noqa: E731
        self.params = dev(state["params"])
        self.exp_avg = dev(state["exp_avg"])
        self.exp_avg_sq = dev(state["exp_avg_sq"])
        self.steps = state["steps"].numpy().astype(np.int64)

    # ------------------------------------------------------------------
    def _schedule(self, orders: List[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """Per-entity start indices -> (n_batches_max, E, bs) starts and
        mask on the device, and the host's (n_batches_max, E) real flags."""
        bs = self.train_config.bs
        per = [batched_starts(0, bs, indices=o) for o in orders]
        n_max = max(p[2] for p in per)
        E = len(per)
        starts = torch.zeros((n_max, E, bs), dtype=torch.int64)
        mask = torch.zeros((n_max, E, bs), dtype=torch.float32)
        real = np.zeros((n_max, E), bool)
        for e, (st, m, _) in enumerate(per):
            starts[: st.shape[0], e] = st
            mask[: m.shape[0], e] = m
            real[: m.shape[0], e] = m.numpy().sum(axis=1) > 0
        return starts.to(self.device), mask.to(self.device), real

    def _step_scalars(self, real: np.ndarray) -> torch.Tensor:
        """(n_batches, 3, E) float32 on the device: each step's learning
        rate over Adam's first bias correction, the square root of the
        second, and the learning rate (``Trainer``'s and
        ``torch.optim.Adam``'s arithmetic, in float64 on the host), each
        entity at its own step; steps where an entity has no batch keep its
        step."""
        cfg = self.train_config
        steps = self.steps.copy()
        out = np.ones((len(real), 3, len(steps)), np.float64)
        for i, row in enumerate(real):
            for e in np.flatnonzero(row):
                t = int(steps[e]) + 1           # Adam's step count after this update
                lr = learning_rate(cfg, int(steps[e]))
                out[i, 0, e] = lr / (1 - BETA1 ** t)
                out[i, 1, e] = (1 - BETA2 ** t) ** 0.5
                out[i, 2, e] = lr
            steps += row
        return torch.from_numpy(out.astype(np.float32)).to(self.device)

    def _generators(self) -> EntityGenerators:
        """Each entity's dropout generator at its own step: its solo
        Trainer's, seeded ``step_seed(seed, step)``."""
        gens = []
        for s in self.steps:
            g = torch.Generator(device=self.device)
            g.manual_seed(step_seed(self.train_config.seed, int(s)))
            gens.append(g)
        return EntityGenerators(gens)

    def _clip(self, grads: Stacked) -> Stacked:
        """``Trainer._clip`` per entity: each entity's gradients scaled by
        max / norm where its own global norm is not below max."""
        max_norm = self.train_config.grad_clip_norm
        if max_norm is None:
            return grads
        norm = torch.sqrt(sum((g.float() ** 2).flatten(1).sum(1) for g in grads.values()))
        out = {}
        for n, g in grads.items():
            nb = _per_entity(norm, g)
            out[n] = torch.where(nb < max_norm, g, g / nb * max_norm)
        return out

    def _apply(self, grads: Stacked, real: torch.Tensor, scalars: torch.Tensor) -> None:
        """One Adam update an entity (``torch.optim.Adam``'s formula: lerp
        into the first moment, addcmul into the second, ``param - step_size
        m / (sqrt(v) / sqrt(bc2) + eps)``), kept only where ``real``."""
        step_size, bc2_sqrt = scalars[0], scalars[1]
        for n, p in self.params.items():
            g = grads[n]
            keep = _per_entity(real, p)
            m = torch.lerp(self.exp_avg[n], g, 1 - BETA1)
            v = torch.addcmul(self.exp_avg_sq[n] * BETA2, g, g, value=1 - BETA2)
            denom = v.sqrt() / _per_entity(bc2_sqrt, p) + EPS
            new = p - _per_entity(step_size, p) * m / denom
            self.params[n] = torch.where(keep, new, p)
            self.exp_avg[n] = torch.where(keep, m, self.exp_avg[n])
            self.exp_avg_sq[n] = torch.where(keep, v, self.exp_avg_sq[n])

    def train_epoch(self, series: torch.Tensor, starts: torch.Tensor, mask: torch.Tensor,
                    real: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One vmapped optimizer step for all entities per row of ``starts``
        / ``mask`` (n_batches, E, bs); returns each step's per-entity
        (forecast, recon) RMSEs, NaN where an entity had no batch, fetched
        once."""
        scalars = self._step_scalars(real)
        fs, rs = [], []
        for i in range(starts.shape[0]):
            gens = self._generators()
            params = {n: p.detach() for n, p in self.params.items()}
            grads, (_, (f, r)) = self._grad(params, series, starts[i], mask[i], gens)
            grads = self._clip(grads)
            real_i = mask[i].sum(dim=1) > 0
            self._apply(grads, real_i, scalars[i])
            self.steps += real[i]
            self.fleet_steps += 1
            nan = torch.full_like(f, float("nan"))
            fs.append(torch.where(real_i, f.detach(), nan))
            rs.append(torch.where(real_i, r.detach(), nan))
        return torch.stack(fs).cpu().numpy(), torch.stack(rs).cpu().numpy()

    @torch.no_grad()
    def _epoch_eval(self, series, starts, mask) -> Tuple[np.ndarray, np.ndarray]:
        fs, rs = [], []
        for st, m in zip(starts, mask):
            f, r = self._eval(self.params, series, st, m)
            real = m.sum(dim=1) > 0
            nan = torch.full_like(f, float("nan"))
            fs.append(torch.where(real, f, nan))
            rs.append(torch.where(real, r, nan))
        return torch.stack(fs).cpu().numpy(), torch.stack(rs).cpu().numpy()

    @staticmethod
    def _aggregate(fs: np.ndarray, rs: np.ndarray):
        """Per-entity epoch loss: the RMS of that entity's real batch RMSEs
        (its NaN rows excluded), as ``Trainer._aggregate``."""
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            # entities without a batch (no validation windows) give all-NaN columns
            warnings.simplefilter("ignore", RuntimeWarning)
            f = np.sqrt(np.nanmean(np.asarray(fs, np.float64) ** 2, axis=0))
            r = np.sqrt(np.nanmean(np.asarray(rs, np.float64) ** 2, axis=0))
        return f, r, f + r

    # ------------------------------------------------------------------
    def save_fleet(self) -> None:
        """``fleet_state.pt`` in the save path: the stacked weights, Adam's
        moments and the entities' steps (which alone reseed their dropout),
        of every entity; on a mesh the primary writes it (inside ``fit``
        every rank calls this, for the gather)."""
        if self.save_path:
            save_checkpoint(os.path.join(self.save_path, self.FLEET_STATE_FILE), self._state())

    def load_fleet(self, path: str, n_entities: int) -> None:
        """Restore a fleet state of every entity (written on any number of
        ranks); ``fit`` then skips the epochs it had trained while
        replaying their shuffles, so the resumed run equals the
        uninterrupted one bit for bit, and on a mesh each rank trains its
        own block of it."""
        state = load_checkpoint(path)
        if len(state["steps"]) != n_entities:
            raise ValueError(f"{path} holds {len(state['steps'])} entities, not {n_entities}")
        self._restore(state)

    # ------------------------------------------------------------------
    def fit(self, series_list: List[np.ndarray], verbose: bool = True) -> None:
        """Train every entity for ``train_config.epochs`` in lockstep, each
        on ``Trainer.fit``'s schedule: a shuffled train/validation split,
        a fresh train permutation every epoch, validation in order. On a
        mesh each rank trains its block of the entities (module
        docstring)."""
        cfg = self.train_config
        E = len(series_list)
        if self.params is None:
            self.init_states(E)
        if self.n_entities != E:
            raise ValueError(f"{E} series for a fleet of {self.n_entities} entities")
        lengths = [len(s) for s in series_list]
        n_wins = [num_windows(t, self.window, self.horizon) for t in lengths]
        if min(n_wins) < 1:
            raise ValueError(
                f"series of lengths {lengths} yield no training windows for some entity at "
                f"window={self.window}, horizon={self.horizon}")
        sharded = self._data_group() is not None
        first, end = entity_blocks(E, self.mesh.dp)[self.mesh.data_index] if sharded else (0, E)
        mine = range(first, end)

        # every rank draws every entity's shuffles (host work), each entity
        # from its own generator, and trains its own block
        host_rngs = [np.random.default_rng(cfg.seed) for _ in range(E)]
        train_idx, val_idx = [], []
        for e in range(E):
            idx = np.arange(n_wins[e])
            if cfg.val_split > 0.0:
                split = int(np.floor(cfg.val_split * n_wins[e]))
                if cfg.shuffle_dataset:
                    host_rngs[e].shuffle(idx)
                train_idx.append(idx[split:])
                val_idx.append(idx[:split])
            else:
                train_idx.append(idx)
                val_idx.append(np.array([], np.int64))
        has_val = [len(v) > 0 for v in val_idx]
        my_val = any(has_val[e] for e in mine)
        if mine:
            stacked = np.zeros((len(mine), max(lengths[e] for e in mine),
                                series_list[0].shape[1]), np.float32)
            for i, e in enumerate(mine):
                stacked[i, : lengths[e]] = series_list[e]
            series = torch.from_numpy(stacked).to(self.device)
            if my_val:
                vstarts, vmask, _ = self._schedule([np.sort(val_idx[e]) for e in mine])

        self.losses = [{k: [] for k in ("train_total", "train_forecast", "train_recon",
                                        "val_total", "val_forecast", "val_recon")}
                       for _ in range(E)]
        # entities advance in lockstep, so entity 0's step counts the
        # completed epochs; skipped epochs still draw their shuffles
        n_batches0 = max(1, -(-len(train_idx[0]) // cfg.bs))
        start_epoch = min(cfg.epochs, int(self.steps[0]) // n_batches0)
        if start_epoch and verbose:
            print(f"Resuming fleet at epoch {start_epoch + 1}/{cfg.epochs}")

        if sharded:
            self._narrow(first, end)
            self._blockwise = True
        for epoch in range(cfg.epochs):
            orders = [host_rngs[e].permutation(train_idx[e]) if cfg.shuffle_dataset
                      else train_idx[e] for e in range(E)]
            if epoch < start_epoch:
                continue
            nan = np.full(len(mine), np.nan)
            f = r = tot = vf = vr = vtot = nan
            batches = (np.zeros((0, len(mine))),) * 2
            if mine:
                starts, mask, real = self._schedule([orders[e] for e in mine])
                batches = self.train_epoch(series, starts, mask, real)
                f, r, tot = self._aggregate(*batches)
                if my_val:
                    vf, vr, vtot = self._aggregate(*self._epoch_eval(series, vstarts, vmask))
            f, r, tot, vf, vr, vtot, batches = self._entity_order(
                (f, r, tot, vf, vr, vtot), batches)
            self.last_batch_losses = batches
            for e in range(E):
                for key, val in (("train_forecast", f), ("train_recon", r),
                                 ("train_total", tot)):
                    self.losses[e][key].append(float(val[e]))
                if has_val[e]:
                    for key, val in (("val_forecast", vf), ("val_recon", vr),
                                     ("val_total", vtot)):
                        self.losses[e][key].append(float(val[e]))
            if verbose:
                print(f"[Epoch {epoch + 1}] mean total_loss over {E} entities = "
                      f"{float(np.mean(tot)):.5f}")
            if self.save_path and cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0:
                self.save_fleet()
        if sharded:
            state = self._state()
            self._blockwise = False
            self._restore(state)

    def _entity_order(self, epoch_losses: tuple, batches: tuple) -> tuple:
        """An epoch's per-entity losses and (n_batches, E) batch losses of
        every entity: this rank's gathered with the others' over the data
        axis inside ``fit`` on a mesh (each rank's batch count its own,
        NaN-padded to the most), else as they are."""
        if not self._blockwise:
            return (*epoch_losses, batches)
        every = self._gathered((epoch_losses, batches))
        rows = max(b[0].shape[0] for _, b in every)

        def padded(x):
            return np.concatenate([x, np.full((rows - len(x), x.shape[1]), np.nan)])

        losses = tuple(np.concatenate([el[i] for el, _ in every])
                       for i in range(len(epoch_losses)))
        return (*losses, tuple(np.concatenate([padded(b[i]) for _, b in every], axis=1)
                               for i in range(2)))
