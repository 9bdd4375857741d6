"""The port's MTADGAT forward against the JAX package's ``MTADGAT.apply``
on the CPU, with the JAX init carried across by ``jax_params_to_state_dict``.

Inputs are made with numpy from a seed and fed to both packages in float32.
Tolerance: atol 1e-4 — both sides run the same float32 math, but the two
frameworks sum in other orders (conv, matmuls, softmax, 2x7 GRU-chain
steps), which moves the outputs by a few 1e-6 at these sizes; 1e-4 leaves
an order of magnitude of headroom while a wrong gate, layout or transpose
moves them by 1e-2 or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.models import MTADGAT as JaxMTADGAT
from mtad_gat_tpu.utils.torch_import import (
    params_to_torch_state_dict,
    torch_state_dict_to_params,
)
from mtad_gat_tpu_torch.config import MTADGATConfig
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

K, W, B = 5, 7, 3
ATOL = 1e-4


def _cfg_kwargs(**over):
    kw = dict(
        n_features=K, window_size=W, out_dim=K, gru_hid_dim=12,
        forecast_hid_dim=10, forecast_n_layers=2, recon_hid_dim=9,
        recon_n_layers=1, dropout=0.3,
    )
    kw.update(over)
    return kw


def _pair(**over):
    jcfg = JaxConfig(**_cfg_kwargs(**over))
    jmodel = JaxMTADGAT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, W, K)))["params"]
    model = MTADGAT(MTADGATConfig(**_cfg_kwargs(**over)))
    model.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, model.eval()


@pytest.mark.parametrize(
    "impls",
    [
        dict(attention_impl="pallas", gru_impl="pallas"),
        dict(attention_impl="dense", gru_impl="xla"),
        dict(attention_impl="dense", gru_impl="xla", use_gatv2=False),
    ],
    ids=["pallas+pallas", "dense+xla", "gatv1-dense"],
)
def test_forward_matches_jax(impls):
    jmodel, params, model = _pair(**impls)
    x = np.random.default_rng(1).standard_normal((B, W, K)).astype(np.float32)
    want_p, want_r = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got_p, got_r = model(torch.from_numpy(x))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL)


def test_flagship_width_forward_matches_jax():
    """One forward at the reference's SMD widths (38 features, GRU 150,
    3x150 forecast head) with a cut window, kernels' plain versions on."""
    over = dict(n_features=38, out_dim=38, window_size=12, gru_hid_dim=150,
                forecast_hid_dim=150, forecast_n_layers=3, recon_hid_dim=150,
                attention_impl="pallas", gru_impl="pallas")
    jcfg = JaxConfig(**_cfg_kwargs(**over))
    jmodel = JaxMTADGAT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 12, 38)))["params"]
    model = MTADGAT(MTADGATConfig(**_cfg_kwargs(**over))).eval()
    model.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    x = np.random.default_rng(2).random((2, 12, 38)).astype(np.float32)
    want_p, want_r = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got_p, got_r = model(torch.from_numpy(x))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL)


def test_state_dict_round_trips_through_jax_mapping():
    """jax params -> port state_dict -> JAX torch_state_dict_to_params gives
    the same tree back, and its keys are exactly the port model's."""
    _, params, model = _pair()
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = jax_params_to_state_dict(params)
    assert set(sd) == set(model.state_dict())
    back = torch_state_dict_to_params(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # and the JAX package's own inverse agrees key for key
    ref = params_to_torch_state_dict(params)
    assert set(ref) == set(sd)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])


def test_seeded_init_is_reproducible_and_uses_reference_names():
    a = MTADGAT(MTADGATConfig(**_cfg_kwargs()), generator=torch.Generator().manual_seed(5))
    b = MTADGAT(MTADGATConfig(**_cfg_kwargs()), generator=torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for key in ("conv.conv.weight", "feature_gat.lin.weight", "feature_gat.a",
                "temporal_gat.bias", "gru.gru.weight_hh_l0",
                "forecasting_model.layers.2.bias", "recon_model.decoder.rnn.bias_ih_l0",
                "recon_model.fc.weight"):
        assert key in sa, key
    assert sa["conv.conv.weight"].shape == (K, K, 7)


@pytest.mark.parametrize("over", [
    dict(attention_impl="ring", temporal_graph="band:3", use_gatv2=False),
    dict(attention_impl="ring", temporal_graph="band:3"),
], ids=["gatv1", "gatv2"])
def test_ring_on_a_band_matches_jax(over):
    """Ring attention on a band, which raised until the halo exchange was
    ported: without a mesh both packages take the single-device band path."""
    jmodel, params, model = _pair(**over)
    x = np.random.default_rng(2).standard_normal((B, W, K)).astype(np.float32)
    want_p, want_r = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got_p, got_r = model(torch.from_numpy(x))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL)


def test_training_mode_dropout_raises():
    """Training-mode dropout draws its masks from the caller's generator
    and raises without one, rather than use the global generator."""
    model = MTADGAT(MTADGATConfig(**_cfg_kwargs()))
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model.train()(torch.zeros(1, W, K))
