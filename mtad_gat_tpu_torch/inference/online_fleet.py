"""Fleet serving: stream-score E entities with one forward a chunk.

The port of ``mtad_gat_tpu/inference/online_fleet.py``. The JAX scorer runs
``jax.vmap`` over a stacked parameter tree; here the E entities' weights
are stacked by ``torch.func.stack_module_state`` and one model runs over
them as ``torch.func.vmap(functional_call)``. Under that vmap the no-grad
K1 and K3 calls are custom ops whose vmap rules fold the entities into the
kernels' entity axis (``kernels/_vmap.py``), so a fleet forward launches K1
twice and K3 twice whatever E is, as JAX's batching rule for ``pallas_call``
gives each kernel an entity grid axis.

Records are per entity and equal those of E solo :class:`OnlineScorer`s on
the same inputs: vmap changes the batching, not the function. The
threshold (epsilon, streaming SPOT, dSPOT), the EWM smoother and the record
bookkeeping are host-side, per entity, in host-only ``OnlineScorer``s.

A ragged chunk (each entity brings however many points arrived on its own
stream, zero included) is padded to the longest entity's count K and runs
as ONE vmapped forward of batch K per entity, each entity's K windows
gathered from its ring buffer and its chunk as ``OnlineScorer.update_many``
gathers them. Each entity's buffer and pending forecast then advance through
its own valid rows only, chosen on the device by index tensors: the
function of the JAX scorer's masked ``lax.scan`` over the chunk.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call, stack_module_state

from mtad_gat_tpu_torch.inference.online import (
    OnlineScorer,
    _score,
    atomic_pickle,
    load_state_pickle,
)

Stacked = Union[Dict[str, torch.Tensor], Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]


class OnlineFleetScorer:
    """Streaming scorer over a trained fleet (stacked weights, one model).

    Usage::

        fleet = OnlineFleetScorer.from_models(models, window_size=100,
                                              n_features=38)
        for e, scores in enumerate(train_scores_per_entity):
            fleet.fit_threshold(e, scores, method="spot")
        records = fleet.update_many(xs)     # xs: (E, T, k)
        # records[e] == the records OnlineScorer would produce for entity e

    ``model`` is an ``MTADGAT`` of the fleet's config on its device, the
    module the stacked weights are applied through (its own weights are not
    used). ``stacked_params`` is ``torch.func.stack_module_state``'s output
    for E models of that config, ``(params, buffers)``, or the params alone:
    tensors with a leading entity axis on the model's device.
    """

    def __init__(
        self,
        model,
        stacked_params: Stacked,
        n_entities: int,
        window_size: int,
        n_features: int,
        target_dims: Optional[Sequence[int]] = None,
        gamma: float = 1.0,
        smoothing_span: Optional[int] = None,
    ):
        params, buffers = (stacked_params if isinstance(stacked_params, tuple)
                           else (stacked_params, {}))
        sizes = {t.shape[0] for t in (*params.values(), *buffers.values())}
        if sizes != {n_entities}:
            raise ValueError(f"stacked weights carry entity axes {sorted(sizes)}, "
                             f"expected {n_entities}")
        self.model = model.eval()
        self.params = {k: v.detach() for k, v in params.items()}
        self.buffers = {k: v.detach() for k, v in buffers.items()}
        self.n_entities = n_entities
        self.window = window_size
        self.n_features = n_features
        self.target_dims = None if target_dims is None else list(target_dims)
        self.gamma = gamma
        # optional entity labels (SMD group names), saved with the state so
        # that a resume with a reordered fleet fails instead of swapping
        # every entity's ring buffer and threshold state
        self.labels: Optional[List[str]] = None
        self.out_dim = n_features if self.target_dims is None else len(self.target_dims)
        # forwards run, each one vmapped call over every entity
        self.forwards = 0

        # threshold, EWM and record bookkeeping per entity, host-side; the
        # device work all happens here
        self._entities: List[OnlineScorer] = [
            OnlineScorer(None, window_size, n_features, target_dims=target_dims, gamma=gamma,
                         smoothing_span=smoothing_span)
            for _ in range(n_entities)
        ]
        self.device = next(iter(self.params.values())).device
        self._dims = (None if self.target_dims is None
                      else torch.tensor(self.target_dims, device=self.device))
        self._buffers = torch.zeros((n_entities, window_size, n_features), dtype=torch.float32,
                                    device=self.device)
        self._pendings = torch.zeros((n_entities, self.out_dim), dtype=torch.float32,
                                     device=self.device)

        def entity_forward(params, buffers, x):
            return functional_call(self.model, (params, buffers), (x,))

        self._forward = torch.func.vmap(entity_forward)

    @classmethod
    def from_models(cls, models: Sequence, window_size: int, n_features: int,
                    **kw) -> "OnlineFleetScorer":
        """A fleet over ``models``, E ``MTADGAT``s of one config on one
        device, put in eval mode: their weights stacked, the first as the
        module they run through."""
        models = [m.eval() for m in models]
        if len({repr(m.config) for m in models}) != 1:
            raise ValueError("a fleet's models must share one config")
        return cls(models[0], stack_module_state(models), len(models), window_size,
                   n_features, **kw)

    # ------------------------------------------------------------------
    def fit_threshold(self, entity: int, train_scores, **kw) -> None:
        """Arm entity ``entity``'s alarm (``OnlineScorer.fit_threshold``'s
        signature and semantics)."""
        self._entities[entity].fit_threshold(train_scores, **kw)

    def update_many(self, xs: np.ndarray, pad_to: Optional[int] = None) -> List[List[Dict]]:
        """Feed an aligned chunk (E, T, k), T new points for every entity,
        through one vmapped forward. Returns per-entity record lists, each
        that entity's solo ``OnlineScorer`` records."""
        xs = np.asarray(xs, np.float32)
        if xs.ndim != 3 or xs.shape[0] != self.n_entities:
            raise ValueError(f"xs must be (n_entities={self.n_entities}, T, "
                             f"{self.n_features}), got {xs.shape}")
        return self.update_ragged(list(xs), pad_to=pad_to)

    @torch.inference_mode()
    def update_ragged(self, xs_list: List[np.ndarray],
                      pad_to: Optional[int] = None) -> List[List[Dict]]:
        """Feed a ragged chunk: ``xs_list[e]`` is (T_e, k), the points that
        arrived on entity e's stream (possibly none). Every entity goes
        through one vmapped forward of batch max T_e; padded rows leave no
        trace in any entity's state. ``pad_to`` keeps the JAX scorer's
        contract (a chunk of more rows raises) and pads nothing more: an
        eager forward has no compiled shape to reuse."""
        if len(xs_list) != self.n_entities:
            raise ValueError(f"need {self.n_entities} streams, got {len(xs_list)}")
        xs_list = [np.asarray(x, np.float32).reshape(-1, self.n_features) for x in xs_list]
        counts = np.array([x.shape[0] for x in xs_list], np.int64)
        K = int(counts.max(initial=0))
        if pad_to is not None and K > pad_to:
            raise ValueError(f"chunk of {K} rows exceeds pad_to={pad_to}")
        if K == 0:
            return [[] for _ in range(self.n_entities)]
        E, w, dev = self.n_entities, self.window, self.device
        xs = np.zeros((E, K, self.n_features), np.float32)
        for e, x in enumerate(xs_list):
            xs[e, :x.shape[0]] = x
        x = torch.as_tensor(xs, device=dev)
        n = torch.as_tensor(counts, device=dev)
        seq = torch.cat([self._buffers, x], dim=1)                   # (E, w + K, k)
        # the K windows of every entity, those ending at its chunk's points
        idx = torch.arange(1, K + 1, device=dev)[:, None] + torch.arange(w, device=dev)
        preds, recons = self._forward(self.params, self.buffers, seq[:, idx])
        self.forwards += 1
        preds, recon = preds.float(), recons[:, :, -1].float()        # (E, K, d)
        pending = torch.cat([self._pendings[:, None], preds[:, :-1]], dim=1)
        actual = x if self._dims is None else x[..., self._dims]
        a_score = _score(pending, recon, actual, self.gamma)
        packed = torch.cat([pending, recon, a_score, a_score.mean(dim=2, keepdim=True)],
                           dim=2).cpu().numpy()
        # each entity advances through its own rows only: its last w rows of
        # buffer ++ its valid points, and the forecast of its last window
        rows = n[:, None] + torch.arange(w, device=dev)
        self._buffers = seq.gather(1, rows[..., None].expand(E, w, self.n_features))
        last = preds[torch.arange(E, device=dev), (n - 1).clamp(min=0)]
        self._pendings = torch.where((n > 0)[:, None], last, self._pendings)

        d = self.out_dim
        all_records: List[List[Dict]] = []
        for e, ent in enumerate(self._entities):
            records = []
            start = ent._seen
            ent._seen += int(counts[e])
            for i in range(int(counts[e])):
                t = start + i
                if t < w:              # the pending forecast is not armed yet
                    continue
                record = {"t": t, "entity": e, "forecast": packed[e, i, :d],
                          "recon": packed[e, i, d:2 * d], "a_score": packed[e, i, 2 * d:3 * d],
                          "score": float(packed[e, i, 3 * d])}
                ent._finalize(record)
                records.append(record)
            all_records.append(records)
        return all_records

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """The fleet's streaming state (the ring buffers and pending
        forecasts, and every entity's threshold and EWM state), the JAX
        fleet scorer's keys."""
        return {
            "n_entities": self.n_entities,
            "window": self.window,
            "n_features": self.n_features,
            "labels": self.labels,
            "smoothing_span": self._entities[0].smoothing_span,
            "buffers": self._buffers.cpu().numpy(),
            "pendings": self._pendings.cpu().numpy(),
            "seen": [ent._seen for ent in self._entities],
            "entities": [{k: v for k, v in ent.state_dict().items()
                          if k not in ("buffer", "pending", "seen")}
                         for ent in self._entities],
        }

    def load_state(self, state: Dict) -> None:
        if "scorer" in state and "lines" in state:
            # a serve_cli fleet state file: the scorer's state wrapped with
            # the input streams' positions (cli/serve_cli._save_serving_state)
            state = state["scorer"]
        geometry = (state["n_entities"], state["window"], state["n_features"])
        if geometry != (self.n_entities, self.window, self.n_features):
            raise ValueError(f"fleet state geometry mismatch: {geometry} vs "
                             f"{(self.n_entities, self.window, self.n_features)}")
        saved_labels = state.get("labels")
        if saved_labels is not None:
            if self.labels is not None and list(saved_labels) != list(self.labels):
                raise ValueError(f"fleet state is for entities {saved_labels}, scorer has "
                                 f"{self.labels}: same entities in the same order required")
            # adopted when the scorer has none, so that the order guard
            # survives a resume-then-save cycle through the library
            self.labels = list(saved_labels)
        span = self._entities[0].smoothing_span
        if state.get("smoothing_span") != span:
            raise ValueError(f"fleet state has smoothing_span={state.get('smoothing_span')}, "
                             f"scorer has {span}")
        self._buffers = torch.as_tensor(np.asarray(state["buffers"], np.float32),
                                        device=self.device).clone()
        self._pendings = torch.as_tensor(np.asarray(state["pendings"], np.float32),
                                         device=self.device).clone()
        for ent, es, seen in zip(self._entities, state["entities"], state["seen"]):
            ent._ewm_avg = es["ewm_avg"]
            ent._ewm_old_wt = es["ewm_old_wt"]
            ent._threshold_method = es["threshold_method"]
            ent._epsilon = es["epsilon"]
            ent._spot = es["spot"]
            ent._seen = int(seen)

    def save_state(self, path: str) -> None:
        """Atomically persist :meth:`state_dict` (write, then rename)."""
        atomic_pickle(path, self.state_dict())

    def load_state_file(self, path: str) -> None:
        """Load a fleet state file this package or the JAX package wrote."""
        self.load_state(load_state_pickle(path))
