"""Training runtime.

The port of ``mtad_gat_tpu/training/trainer.py`` (capabilities of reference
``training.py:9-253``): ``Trainer`` with fit / evaluate / save / load and the
same six loss series, on raw series inputs.

- The series is copied to the device once per ``fit``; every batch is a
  gather by window start index on the device.
- Loss as the reference (``training.py:122-124``): RMSE(forecast) +
  RMSE(recon) per batch, epoch loss = RMS of the batch RMSEs; partial final
  batches are padded and masked, as in the JAX package.
- The split and shuffles come from ``np.random.default_rng(seed)`` in the
  JAX package's order (one initial shuffle, a fresh train permutation every
  epoch, validation in fixed order), so both packages see the same batches.
- Adam at torch's defaults, with optional global-norm clipping and cosine /
  warmup-cosine schedules, each computed by optax's own formula.
- Dropout masks come from a generator on the model's device seeded anew at
  every step from (train seed, global step): the counterpart of
  ``jax.random.fold_in(rng, step)``. A restored train state therefore needs
  only its step to continue bit for bit.
- A checkpoint holds params, optimizer state and step (``checkpoint.py``).
- On a mesh (``mesh=``, ``parallel/mesh.make_mesh``; one rank a process
  and a device), each rank runs every step on its data slice's columns of
  the batch (``multihost.epoch_arrays``; a batch the data axis does not
  divide is padded with masked slots), and the RMSEs' numerators and
  mask counts are summed over the data axis before the square root (an
  RMSE is not a mean of the ranks' RMSEs). After ``backward`` the
  parameter gradients of the ring and halo layers (each model rank's part
  of the whole, ``GATLayer.partial_grads``) are summed over the model axis,
  then
  every gradient over the data axis; clipping and Adam follow on every
  rank alike, so the ranks' parameters stay equal. Dropout generators are
  seeded from (seed, step, data index): the model ranks of a data slice
  compute the same activations and draw the same masks, and data slices
  draw their own. With a model axis, cuDNN is held to its deterministic
  algorithms, so that the model ranks' replicated gradients are equal.
  Only the primary rank writes checkpoints and metrics.
- ``profile_dir`` traces one epoch's steps with ``torch.profiler``
  (``utils/profiling.trace``): the first epoch after the first that runs,
  or the only one, as the JAX trainer picks it; on a mesh every rank
  writes its own file. The trace changes nothing that is computed.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.data.windows import batched_starts, num_windows, window_batch
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.nn.gat import GATLayer
from mtad_gat_tpu_torch.parallel import multihost
from mtad_gat_tpu_torch.parallel.sharding import all_reduce_, data_sum, use_mesh
from mtad_gat_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from mtad_gat_tpu_torch.training.metrics import MetricsLogger
from mtad_gat_tpu_torch.utils.profiling import force_completion, trace


def masked_rmse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """sqrt(MSE) over valid windows only. mask: (b,) 1.0 for real windows.
    On a mesh with more than one data slice, the squared errors' sum and
    the mask count are summed over the data axis before the division."""
    pred = pred.float()
    target = target.float()
    per_win = ((pred - target) ** 2).reshape(pred.shape[0], -1).mean(dim=1)
    if mesh is not None and mesh.dp > 1:
        num = data_sum((per_win * mask).sum(), mesh)
        return torch.sqrt(num / torch.clamp(data_sum(mask.sum(), mesh), min=1.0))
    w = mask / torch.clamp(mask.sum(), min=1.0)
    return torch.sqrt((per_win * w).sum())


def make_loss_fn(model: MTADGAT, window: int, horizon: int, target_dims, mesh=None):
    """Batch loss = RMSE(forecast) + RMSE(recon) over one window batch
    gathered on the device from the series (reference training.py:113-124).
    ``deterministic`` puts the model in eval mode (no dropout); otherwise it
    trains and draws its masks from ``generator``. ``params`` (a name ->
    tensor dict) runs the model on those weights instead of its own, through
    ``torch.func.functional_call``: the form a fleet step vmaps. ``mesh``
    is active around the model (its ring and halo layers read it) and sums the
    RMSEs over its data axis."""
    dims = None if target_dims is None else list(target_dims)

    def loss_fn(series, starts, mask, generator, deterministic: bool, params=None):
        x, y = window_batch(series, starts, window, horizon)
        model.train(not deterministic)
        args = (x, None if deterministic else generator)
        with use_mesh(mesh):
            preds, recons = (model(*args) if params is None
                             else torch.func.functional_call(model, params, args))
        x_t, y_t = x, y
        if dims is not None:
            x_t = x_t[:, :, dims]
            y_t = y_t[:, :, dims]
        y_t = y_t[:, 0, :]
        f = masked_rmse(preds, y_t, mask, mesh)
        r = masked_rmse(recons, x_t, mask, mesh)
        return f + r, (f, r)

    return loss_fn


def _cosine(init: float, decay_steps: int, count: int, alpha: float = 0.0) -> float:
    """optax.cosine_decay_schedule(init, decay_steps, alpha)(count)."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")
    count = min(count, decay_steps)
    return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha)


def learning_rate(cfg: TrainConfig, step: int) -> float:
    """The learning rate of the update at 0-based ``step``, as optax's
    schedules give it (``trainer.py:146-155`` of the JAX package)."""
    if cfg.lr_schedule == "constant":
        return cfg.init_lr
    if cfg.lr_schedule == "cosine":
        return _cosine(cfg.init_lr, cfg.lr_decay_steps, step)
    if cfg.lr_schedule == "warmup_cosine":
        # optax.warmup_cosine_decay_schedule(0.0, init_lr, warmup, decay):
        # a linear ramp from 0, then a cosine over the remaining steps
        warmup = cfg.lr_warmup_steps
        if step < warmup:
            return cfg.init_lr * min(step, warmup) / warmup
        return _cosine(cfg.init_lr, cfg.lr_decay_steps - warmup, step - warmup)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule}")


def step_seed(seed: int, step: int, data_index: int = 0) -> int:
    """The seed of step ``step``'s dropout generator, a pure function of
    (train seed, step): the counterpart of ``jax.random.fold_in``. Data
    slice ``data_index`` of a mesh draws its own (slice 0 the single
    device's)."""
    key = [seed, step] if data_index == 0 else [seed, step, data_index]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


def _sum_over(grads, group) -> None:
    """Sum the tensors of ``grads`` in place over ``group``, as one buffer."""
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


class Trainer:
    """fit / evaluate / save / load, mirroring the reference Trainer API
    surface (``training.py:83,187,231,243``) on raw series inputs. The model
    and its optimizer live on ``device``; ``mesh`` trains over its ranks
    (module docstring)."""

    def __init__(
        self,
        model_config: MTADGATConfig,
        train_config: TrainConfig,
        target_dims: Optional[Sequence[int]] = None,
        save_path: str = "",
        log_dir: str = "output/logs",
        args_summary: str = "",
        horizon: int = 1,
        device: str = "cuda",
        mesh=None,
    ):
        learning_rate(train_config, 0)   # an unknown schedule raises here
        if mesh is not None and mesh.mp > 1:
            # the model ranks of a data slice each compute the gradients of
            # the layers they replicate, and must get the same bits: cuDNN's
            # default weight-gradient algorithm for the conv sums with
            # atomics, and two model ranks' conv gradients differed in their
            # last bits on an H100 (so did their parameters after an epoch)
            torch.backends.cudnn.deterministic = True
        self.mesh = mesh
        self.model_config = model_config
        self.train_config = train_config
        self.target_dims = None if target_dims is None else tuple(target_dims)
        self.save_path = save_path
        self.horizon = horizon
        self.window = model_config.window_size
        self.device = torch.device(device)

        self.losses = {
            "train_total": [],
            "train_forecast": [],
            "train_recon": [],
            "val_total": [],
            "val_forecast": [],
            "val_recon": [],
        }
        # per-batch (forecast, recon) RMSEs of the last trained epoch
        self.last_batch_losses: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.epoch_times = []
        self.model: Optional[MTADGAT] = None
        self.optimizer: Optional[torch.optim.Adam] = None
        self.step = 0
        # step restored by load_full(): the next fit() resumes from it
        self._resume_step = 0
        self.logger = MetricsLogger(log_dir, use_tensorboard=train_config.log_tensorboard,
                                    args_summary=args_summary,
                                    enabled=multihost.is_primary())

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> MTADGAT:
        """A fresh model from ``seed`` (default: the train seed), Adam state
        and step 0."""
        seed = self.train_config.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        self.model = MTADGAT(self.model_config, generator=gen).to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=learning_rate(self.train_config, 0))
        self.step = 0
        self._loss_fn = make_loss_fn(self.model, self.window, self.horizon, self.target_dims,
                                     self.mesh)
        # parameters whose gradient each model rank holds a part of
        self._ring_params = [p for m in self.model.modules()
                             if isinstance(m, GATLayer) and m.partial_grads(self.mesh)
                             for p in m.parameters()]
        return self.model

    def _clip(self) -> None:
        """optax.clip_by_global_norm: scale every gradient by max/norm when
        the global norm is not below max."""
        max_norm = self.train_config.grad_clip_norm
        if max_norm is None:
            return
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        for g in grads:
            g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))

    def step_generator(self) -> torch.Generator:
        """The dropout generator of the next step on this rank's device."""
        data_index = 0 if self.mesh is None else self.mesh.data_index
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(step_seed(self.train_config.seed, self.step, data_index))

    def step_gradients(self, series: torch.Tensor, starts: torch.Tensor, mask: torch.Tensor,
                       generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (forecast, recon) RMSEs of one batch, whose gradients it
        leaves in the parameters' ``grad``: ``starts`` and ``mask`` (ceil(bs / dp),)
        are this rank's windows, and on a mesh the gradients are summed
        over it (the ring and halo layers' over the model axis, then all over the
        data axis), so every rank holds the whole batch's."""
        total, (f, r) = self._loss_fn(series, starts, mask, generator, False)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        mesh = self.mesh
        if mesh is not None and mesh.size > 1:
            for p in self.model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self._ring_params and mesh.model_group is not None:
                _sum_over([p.grad for p in self._ring_params], mesh.model_group)
            if mesh.data_group is not None:
                _sum_over([p.grad for p in self.model.parameters()], mesh.data_group)
        return f, r

    def train_epoch(self, series: torch.Tensor, starts: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """One optimizer step per row of ``starts`` / ``mask`` (n_batches, bs)
        on the device series; returns the per-batch (forecast, recon) RMSEs.
        On a mesh each rank steps on its data slice's columns."""
        fs, rs = [], []
        starts, mask = multihost.epoch_arrays(self.mesh, starts, mask)
        for st, m in zip(starts.to(self.device), mask.to(self.device)):
            f, r = self.step_gradients(series, st, m, self.step_generator())
            self._clip()
            for group in self.optimizer.param_groups:
                group["lr"] = learning_rate(self.train_config, self.step)
            self.optimizer.step()
            self.step += 1
            fs.append(f.detach())
            rs.append(r.detach())
        return torch.stack(fs).cpu().numpy(), torch.stack(rs).cpu().numpy()

    @torch.no_grad()
    def _epoch_eval(self, series, starts, mask) -> Tuple[np.ndarray, np.ndarray]:
        fs, rs = [], []
        starts, mask = multihost.epoch_arrays(self.mesh, starts, mask)
        for st, m in zip(starts.to(self.device), mask.to(self.device)):
            _, (f, r) = self._loss_fn(series, st, m, None, True)
            fs.append(f)
            rs.append(r)
        return torch.stack(fs).cpu().numpy(), torch.stack(rs).cpu().numpy()

    def _series(self, series: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(series, dtype=np.float32)).to(self.device)

    @staticmethod
    def _aggregate(f_losses: np.ndarray, r_losses: np.ndarray) -> Tuple[float, float, float]:
        """Epoch loss = RMS of batch RMSEs (reference training.py:132-138)."""
        f = float(np.sqrt((np.asarray(f_losses) ** 2).mean()))
        r = float(np.sqrt((np.asarray(r_losses) ** 2).mean()))
        return f, r, f + r

    def evaluate(self, series: np.ndarray) -> Tuple[float, float, float]:
        """Forecast/recon/total loss over all windows of a series, unshuffled
        (reference training.py:187-229)."""
        assert self.model is not None, "call init_state() first"
        n = num_windows(len(series), self.window, self.horizon)
        if n < 1:
            raise ValueError(
                f"series of length {len(series)} yields no windows at "
                f"window={self.window}, horizon={self.horizon}")
        starts, mask, _ = batched_starts(n, self.train_config.bs)
        return self._aggregate(*self._epoch_eval(self._series(series), starts, mask))

    def _eval_indices(self, series: torch.Tensor, indices) -> Tuple[float, float, float]:
        starts, mask, _ = batched_starts(0, self.train_config.bs, indices=indices)
        return self._aggregate(*self._epoch_eval(series, starts, mask))

    # ------------------------------------------------------------------
    def fit(self, train_series: np.ndarray) -> None:
        """Train for train_config.epochs with an internal train/val window
        split (reference train.py:67-72 + training.py:83-185)."""
        cfg = self.train_config
        if self.model is None:
            self.init_state()

        n_win = num_windows(len(train_series), self.window, self.horizon)
        if n_win < 1:
            # an all-padding epoch would train on nothing, and the masked
            # RMSE's gradient at an all-zero mask is NaN: fail loudly
            raise ValueError(
                f"series of length {len(train_series)} yields no training "
                f"windows at window={self.window}, horizon={self.horizon}")
        series = self._series(train_series)

        # Initial shuffle + split (utils.py:123-150)
        host_rng = np.random.default_rng(cfg.seed)
        indices = np.arange(n_win)
        if cfg.val_split > 0.0:
            split = int(np.floor(cfg.val_split * n_win))
            if cfg.shuffle_dataset:
                host_rng.shuffle(indices)
            train_idx, val_idx = indices[split:], indices[:split]
        else:
            train_idx, val_idx = indices, None
        has_val = val_idx is not None and len(val_idx) > 0

        # Resume: a state restored by load_full() skips its completed epochs
        # while still drawing their shuffles from host_rng, so the remaining
        # schedule is the uninterrupted run's. A second fit() on a trained
        # trainer trains cfg.epochs more (the reference's semantics).
        _, _, n_batches = batched_starts(0, cfg.bs, indices=train_idx)
        start_epoch = min(cfg.epochs, self._resume_step // n_batches)
        self._resume_step = 0

        if start_epoch == 0:
            init_train = self._eval_indices(series, np.sort(train_idx))
            print(f"Init total train loss: {init_train[2]:.5f}")
            if has_val:
                init_val = self._eval_indices(series, np.sort(val_idx))
                print(f"Init total val loss: {init_val[2]:.5f}")
        else:
            print(f"Resuming at epoch {start_epoch + 1}/{cfg.epochs} (step {self.step})")

        # profile_dir traces the first steady epoch that runs (the first one
        # warms the allocator and the kernels' first calls up); a one-epoch
        # run traces its only epoch
        profile_epoch = min(start_epoch + 1, cfg.epochs - 1)

        print(f"Training model for {cfg.epochs} epochs..")
        train_start = time.time()
        for epoch in range(cfg.epochs):
            epoch_start = time.time()
            order = host_rng.permutation(train_idx) if cfg.shuffle_dataset else train_idx
            if epoch < start_epoch:
                continue  # trained before the restart; the rng stream advanced
            starts, mask, _ = batched_starts(0, cfg.bs, indices=order)
            if cfg.profile_dir and epoch == profile_epoch:
                with trace(cfg.profile_dir, self.device):
                    fs, rs = self.train_epoch(series, starts, mask)
                    force_completion(list(self.model.parameters()))
            else:
                fs, rs = self.train_epoch(series, starts, mask)
            self.last_batch_losses = (fs, rs)
            f, r, total = self._aggregate(fs, rs)

            self.losses["train_forecast"].append(f)
            self.losses["train_recon"].append(r)
            self.losses["train_total"].append(total)
            scalars = {"train_forecast": f, "train_recon": r, "train_total": total}

            if has_val:
                vf, vr, vt = self._eval_indices(series, np.sort(val_idx))
                self.losses["val_forecast"].append(vf)
                self.losses["val_recon"].append(vr)
                self.losses["val_total"].append(vt)
                scalars.update({"val_forecast": vf, "val_recon": vr, "val_total": vt})
                # the reference saves every epoch (its best-val condition at
                # training.py:152-153 is vacuously true): save the latest
                if self.save_path:
                    self.save()
            elif (self.save_path and cfg.checkpoint_every
                  and (epoch + 1) % cfg.checkpoint_every == 0):
                self.save()

            self.logger.log(epoch, scalars)
            epoch_time = time.time() - epoch_start
            self.epoch_times.append(epoch_time)

            if epoch % cfg.print_every == 0:
                s = (f"[Epoch {epoch + 1}] forecast_loss = {f:.5f}, "
                     f"recon_loss = {r:.5f}, total_loss = {total:.5f}")
                if has_val:
                    s += (f" ---- val_forecast_loss = {scalars['val_forecast']:.5f}, "
                          f"val_recon_loss = {scalars['val_recon']:.5f}, "
                          f"val_total_loss = {scalars['val_total']:.5f}")
                s += f" [{epoch_time:.1f}s]"
                print(s)

        if not has_val and self.save_path:
            self.save()

        train_time = int(time.time() - train_start)
        self.logger.text("total_train_time", str(train_time))
        print(f"-- Training done in {train_time}s.")

    # ------------------------------------------------------------------
    def _params(self) -> dict:
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    def save(self, file_name: str = "model.pt") -> None:
        """``file_name`` (the state_dict) and ``train_state.pt`` (params,
        optimizer state, step) in the save path, written by the primary
        rank; on a mesh every rank returns once they are written."""
        assert self.model is not None
        if multihost.is_primary():
            os.makedirs(self.save_path or ".", exist_ok=True)
            params = self._params()
            save_checkpoint(os.path.join(self.save_path, file_name), params)
            save_checkpoint(os.path.join(self.save_path, "train_state.pt"), {
                "params": params, "optimizer": self.optimizer.state_dict(), "step": self.step,
            })
        if self.mesh is not None:
            multihost.barrier()

    def load(self, path: str) -> None:
        """Load the model's parameters from a ``model.pt``."""
        if self.model is None:
            self.init_state()
        self.model.load_state_dict(load_checkpoint(path))

    def load_torch(self, path: str) -> None:
        """Warm-start from a reference PyTorch ``model.pt`` (reference
        ``training.py:231-241``), checking every key and shape against this
        model first so that an architecture mismatch fails with its names."""
        if self.model is None:
            self.init_state()
        got = load_checkpoint(path)
        want = self.model.state_dict()
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        mism = sorted(k for k in set(want) & set(got) if tuple(want[k].shape) != tuple(got[k].shape))
        if missing or extra or mism:
            raise ValueError(f"torch checkpoint {path} does not match this model: "
                             f"missing={missing} extra={extra} shape-mismatch={mism}")
        self.model.load_state_dict(got)

    def load_full(self, path: str) -> None:
        """True resume: params, optimizer state and step from a
        ``train_state.pt``; the next fit() continues from that step."""
        if self.model is None:
            self.init_state()
        state = load_checkpoint(path)
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self._resume_step = self.step
