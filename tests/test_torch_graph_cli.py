"""The graph variants through the port's model and CLIs, against the JAX
package's, on the CPU.

- ``MTADGAT`` forward on the port's init, carried to the JAX model by the
  JAX package's ``torch_state_dict_to_params`` (and back unchanged by the
  port's ``jax_params_to_state_dict``), in eval mode, for each graph variant: a
  k-NN feature graph (COO), a band (unrolled), a band wider than
  ``BAND_UNROLL_CUTOFF`` with ``bias_storage="band"`` (block scan, the
  (N, 2W+1) bias carried unchanged), GATv1 on a band, and
  ``attention_impl="sparse"`` (COO) on the complete and the banded graph.
  atol 1e-4, the tolerance of ``test_torch_model.py`` (the same float32
  math summed in other orders).
- ``train_cli`` with ``--feature_graph knn:3 --temporal_graph band:2`` at
  dropout 0, both packages warm-started from one ``model.pt`` (the port
  model's init): the same
  k-NN edges in ``config.txt``, and summaries whose numbers agree to rtol
  1e-4 with equal counts (the trainers follow one trajectory within 2e-4,
  ``test_torch_training.py``); the port's ``predict_cli`` rebuilds the
  graph from ``config.txt`` and reproduces its run's summary exactly.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import RunConfig as JaxRunConfig
from mtad_gat_tpu.data import synthetic_series
from mtad_gat_tpu.graph import knn_edges_from_series
from mtad_gat_tpu.models import MTADGAT as JaxMTADGAT
from mtad_gat_tpu.utils.torch_import import torch_state_dict_to_params
from mtad_gat_tpu_torch.cli import predict_cli, train_cli
from mtad_gat_tpu_torch.config import MTADGATConfig, RunConfig
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

K, W, B = 5, 40, 3
EDGES = knn_edges_from_series(np.random.default_rng(0).standard_normal((200, K)).cumsum(0), 2)


def _kw(**over):
    kw = dict(n_features=K, window_size=W, out_dim=K, feat_gat_embed_dim=6,
              time_gat_embed_dim=4, gru_hid_dim=8, forecast_hid_dim=8, forecast_n_layers=1,
              recon_hid_dim=8, dropout=0.0, gru_impl="xla")
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    dict(feature_graph="knn:2", feature_edges=EDGES),
    dict(temporal_graph="band:3"),
    dict(temporal_graph="band:33", bias_storage="band"),
    dict(temporal_graph="band:4", bias_storage="band", use_gatv2=False),
    dict(attention_impl="sparse"),
    dict(attention_impl="sparse", temporal_graph="band:3", bias_storage="band"),
], ids=["knn", "band-unrolled", "band-scan-band-bias", "gatv1-band", "sparse",
        "sparse-band-band-bias"])
def test_model_forward_matches_jax(over):
    torch.manual_seed(1)
    model = MTADGAT(MTADGATConfig(**_kw(**over))).eval()
    if over.get("bias_storage") == "band":
        w = int(over["temporal_graph"].split(":")[1])
        assert model.temporal_gat.bias.shape == (W, 2 * w + 1)
        # a nonzero band bias, so that its layout matters
        bias = np.random.default_rng(2).standard_normal((W, 2 * w + 1)).astype(np.float32)
        with torch.no_grad():
            model.temporal_gat.bias.copy_(torch.from_numpy(bias))
    # the JAX model takes the port's init through the JAX package's own
    # mapping; the port's bridge carries those parameters back unchanged
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = torch_state_dict_to_params(sd)
    back = jax_params_to_state_dict(params)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    x = np.random.default_rng(3).standard_normal((B, W, K)).astype(np.float32)
    jmodel = JaxMTADGAT(JaxConfig(**_kw(**over)))
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-4)


def _write_smd(root):
    proc = root / "data" / "ServerMachineDataset" / "processed"
    os.makedirs(proc)
    train, test, labels = synthetic_series(n_train=200, n_test=160, n_features=38, seed=11)
    for name, arr in (("machine-1-1_train.pkl", train), ("machine-1-1_test.pkl", test),
                      ("machine-1-1_test_label.pkl", labels.astype(np.float32))):
        with open(proc / name, "wb") as f:
            pickle.dump(arr, f)


def test_knn_and_band_train_then_predict_match_jax_clis(tmp_path):
    from mtad_gat_tpu.cli.train_cli import run_training as jax_run_training

    _write_smd(tmp_path)
    flags = dict(lookback=8, bs=64, epochs=1, feat_gat_embed_dim=4, time_gat_embed_dim=4,
                 gru_hid_dim=8, fc_hid_dim=8, fc_n_layers=1, recon_hid_dim=8, dropout=0.0,
                 feature_graph="knn:3", temporal_graph="band:2", log_tensorboard=False)
    # one init for both: the port model's, as a model.pt (knn and band keep
    # the complete graph's parameter shapes)
    torch.manual_seed(3)
    cfg = RunConfig(**{k: v for k, v in flags.items()
                       if k not in ("feature_graph", "temporal_graph")})
    init = str(tmp_path / "init.pt")
    torch.save(MTADGAT(cfg.model_config(38, 38)).state_dict(), init)

    data = str(tmp_path / "data")
    jax_run = jax_run_training(
        JaxRunConfig(**flags, data_root=data, output_root=str(tmp_path / "jax")),
        run_id="r1", init_from_torch=init)
    argv = ["--dataset", "SMD", "--group", "1-1", "--data_root", data,
            "--output_root", str(tmp_path / "port")]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    port_run = train_cli.main(argv + ["--run_id", "r1", "--device", "cpu",
                                      "--init_from_torch", init])

    cfgs = [json.load(open(os.path.join(r, "config.txt"))) for r in (port_run, jax_run)]
    assert cfgs[0]["feature_edges"] == cfgs[1]["feature_edges"]
    assert len(cfgs[0]["feature_edges"][0]) == 38 * 4            # 3 neighbours + self
    got, want = (json.load(open(os.path.join(r, "summary.txt"))) for r in (port_run, jax_run))
    assert got.keys() == want.keys() == {"epsilon_result", "pot_result", "bf_result"}
    for method in want:
        for k in want[method]:
            np.testing.assert_allclose(got[method][k], want[method][k], rtol=1e-4,
                                       err_msg=f"{method}.{k}")
    predict_cli.main(argv[:8] + ["--model_id", "r1", "--device", "cpu"])
    assert json.load(open(os.path.join(port_run, "summary_1.txt"))) == got
