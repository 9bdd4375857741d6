"""Weights carried across: the JAX package's flax parameter tree to this
package's ``state_dict``, a fleet's E ``state_dict``s stacked and unstacked,
and reading a ``model.pt``.

The port names its parameters with the reference torch ``state_dict`` keys,
so a reference ``model.pt`` (or one written by the JAX package's
``save_torch_checkpoint``) loads with ``model.load_state_dict`` as it is.
``jax_params_to_state_dict`` is this package's own copy of the JAX
package's tree-to-torch mapping; layout differences:

- conv kernel WIO (kw, in, out) -> torch Conv1d (out, in, kw);
- Linear and GRU weights are stored transposed, (in, out) -> (out, in);
- the GAT attention vector ``a`` and the (N, N) score bias are unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def jax_params_to_state_dict(params: Mapping[str, dict]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's flax ``params`` tree (nested dicts of numpy or
    array-like leaves) to this package's ``state_dict`` (float32 tensors)."""
    p = params
    sd: Dict[str, torch.Tensor] = {
        "conv.conv.weight": _t(np.asarray(p["conv"]["kernel"]).transpose(2, 1, 0)),
        "conv.conv.bias": _t(p["conv"]["bias"]),
    }
    for name in ("feature_gat", "temporal_gat"):
        core = p[name]["core"]
        sd[f"{name}.lin.weight"] = _t(np.asarray(core["lin_kernel"]).T)
        sd[f"{name}.lin.bias"] = _t(core["lin_bias"])
        sd[f"{name}.a"] = _t(core["a"])
        if "bias" in core:
            sd[f"{name}.bias"] = _t(core["bias"])

    def gru(tree: Mapping[str, np.ndarray], prefix: str) -> None:
        for key, arr in tree.items():
            kind, side, layer = key.split("_", 2)  # w/b, ih/hh, lN
            arr = np.asarray(arr)
            if kind == "w":
                sd[f"{prefix}.weight_{side}_{layer}"] = _t(arr.T)
            else:
                sd[f"{prefix}.bias_{side}_{layer}"] = _t(arr)

    gru(p["gru"], "gru.gru")
    gru(p["recon_model"]["decoder"], "recon_model.decoder.rnn")
    for name, lin in p["forecasting_model"].items():
        i = name.split("_")[1]
        sd[f"forecasting_model.layers.{i}.weight"] = _t(np.asarray(lin["kernel"]).T)
        sd[f"forecasting_model.layers.{i}.bias"] = _t(lin["bias"])
    sd["recon_model.fc.weight"] = _t(np.asarray(p["recon_model"]["fc"]["kernel"]).T)
    sd["recon_model.fc.bias"] = _t(p["recon_model"]["fc"]["bias"])
    return sd


def _entity(tree, e: int):
    """Entity ``e``'s slice of a tree whose leaves carry a leading entity axis."""
    if isinstance(tree, Mapping):
        return {k: _entity(v, e) for k, v in tree.items()}
    return np.asarray(tree)[e]


def jax_stacked_params_to_state_dicts(params: Mapping[str, dict]) -> List[Dict[str, torch.Tensor]]:
    """Map the JAX package's stacked fleet parameters (a flax ``params``
    tree whose leaves are numpy arrays with a leading entity axis (E, ...),
    as ``MultiEntityTrainer.params`` or ``jax.tree.map(jnp.stack, ...)``
    give them) to E of this package's ``state_dict``s, one an entity, each
    through ``jax_params_to_state_dict``."""
    sizes = set()

    def collect(tree):
        for v in tree.values():
            if isinstance(v, Mapping):
                collect(v)
            else:
                sizes.add(np.shape(v)[0] if np.ndim(v) else None)

    collect(params)
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"stacked params carry leading axes {sorted(map(str, sizes))}, "
                         "expected one entity axis on every leaf")
    return [jax_params_to_state_dict(_entity(params, e)) for e in range(sizes.pop())]


Stacked = Dict[str, torch.Tensor]


def stack_state_dicts(state_dicts: Sequence[Mapping[str, torch.Tensor]]) -> Stacked:
    """E ``state_dict``s of one config -> one dict of (E, ...) float32
    tensors, the form a fleet trains (``training/multi_entity.py``)."""
    keys = list(state_dicts[0])
    if any(list(sd) != keys for sd in state_dicts):
        raise ValueError("the entities' state_dicts hold different keys")
    return {k: torch.stack([sd[k].float() for sd in state_dicts]) for k in keys}


def unstack_state_dict(stacked: Mapping[str, torch.Tensor], e: int) -> Dict[str, torch.Tensor]:
    """Entity e's ``state_dict`` (CPU tensors) out of stacked weights."""
    return {k: v[e].detach().cpu().clone() for k, v in stacked.items()}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``model.pt`` state_dict (reference ``training.py:231-241``
    format) onto the CPU. Only tensors are unpickled."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path} does not hold a state_dict")
    return dict(sd)
