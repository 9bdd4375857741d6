"""The port reads the JAX package's ``model.msgpack`` without flax or
msgpack, on the CPU.

- ``read_flax_msgpack`` on what a JAX ``Trainer.save`` writes
  (``model.msgpack`` and ``train_state.msgpack``, optax state and PRNG key
  included) gives flax's own ``msgpack_restore`` tree, leaf for leaf, bit
  for bit and dtype for dtype; scalars of every msgpack width and a chunked
  array (flax's chunk size made small) too.
- bfloat16 and complex arrays, and data that is not msgpack, are refused
  with errors that name them.
- ``predict_cli``: the JAX precedence (``--torch_ckpt``, else
  ``model.msgpack``, else ``model.pt``). A JAX ``train_cli`` run (tiny
  widths, 1 epoch) scored by the port's ``predict_cli`` gives the JAX
  ``predict_cli``'s summary: thresholds are functions of scores that agree
  within 1e-5, so the summaries' numbers agree to rtol 1e-4 and their
  counts (TP, FP, ...) are equal. With a ``model.pt`` of other weights put
  beside ``model.msgpack``, both packages still score the msgpack weights,
  and with ``--torch_ckpt`` both score the ``model.pt``'s.
"""

import json
import os
import pickle
import sys
from unittest import mock

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import RunConfig as JaxRunConfig
from mtad_gat_tpu.config import TrainConfig as JaxTrainConfig
from mtad_gat_tpu.data import synthetic_series
from mtad_gat_tpu.training import Trainer as JaxTrainer
from mtad_gat_tpu.utils.torch_import import save_torch_checkpoint
from mtad_gat_tpu_torch.training.checkpoint import read_flax_msgpack

torch.set_num_threads(1)


def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert type(got) is type(want) or isinstance(want, np.ndarray), (path, got, want)
        got_a, want_a = np.asarray(got), np.asarray(want)
        assert got_a.dtype == want_a.dtype and got_a.shape == want_a.shape, path
        assert got_a.tobytes() == want_a.tobytes(), path


def test_jax_trainer_save_round_trips_bit_for_bit(tmp_path):
    mc = JaxConfig(n_features=4, window_size=6, out_dim=4, gru_hid_dim=5, forecast_hid_dim=5,
                   forecast_n_layers=2, recon_hid_dim=5, temporal_graph="band:2",
                   bias_storage="band")
    tr = JaxTrainer(mc, JaxTrainConfig(epochs=1, bs=8, log_tensorboard=False),
                    save_path=str(tmp_path), log_dir=str(tmp_path / "logs"))
    tr.init_state()
    tr.save("model.msgpack")
    for name in ("model.msgpack", "train_state.msgpack"):
        with open(tmp_path / name, "rb") as f:
            want = fser.msgpack_restore(f.read())
        _same_tree(read_flax_msgpack(str(tmp_path / name)), want)
    got = read_flax_msgpack(str(tmp_path / "model.msgpack"))["params"]
    assert got["temporal_gat"]["core"]["bias"].shape == (6, 5)
    jax_leaves = jax.tree_util.tree_leaves_with_path(tr.state.params)
    for path, leaf in jax_leaves:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_scalars_and_chunked_arrays_decode_as_flax(tmp_path, monkeypatch):
    tree = {"ints": {str(i): v for i, v in enumerate(
                [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33,
                 -128, -129, -32768, -32769, -2**31 - 1, -2**63])},
            "floats": [0.5, -1e300, float("inf")], "none": None, "t": True, "f": False,
            "str": "x" * 40, "long": "y" * 300, "bytes": b"\x00\xff" * 200,
            "list": list(range(20)), "np": np.float32(2.5), "i8": np.int8(-3),
            "big": np.arange(3000, dtype=np.float64).reshape(30, 100),
            "u16": np.arange(7, dtype=np.uint16), "flag": np.array([True, False])}
    tree["wide"] = {str(i): i for i in range(20)}
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 1000)   # "big" is 24,000 bytes: chunked
    data = fser.msgpack_serialize(tree)
    (tmp_path / "x.msgpack").write_bytes(data)
    got = read_flax_msgpack(str(tmp_path / "x.msgpack"))
    want = fser.msgpack_restore(data)
    assert isinstance(want["big"], np.ndarray)
    for k in ("big", "np", "i8", "u16", "flag"):
        _same_tree(got[k], want[k], k)
    for k in ("ints", "floats", "none", "t", "f", "str", "long", "bytes", "list", "wide"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("leaf,match", [
    (jnp.ones((2, 3), jnp.bfloat16), "bfloat16"),
    (np.ones(2, np.complex64), "complex64"),
])
def test_unsupported_dtypes_are_refused(leaf, match, tmp_path):
    (tmp_path / "x.msgpack").write_bytes(fser.msgpack_serialize({"params": {"w": leaf}}))
    with pytest.raises(ValueError, match=match):
        read_flax_msgpack(str(tmp_path / "x.msgpack"))


@pytest.mark.parametrize("data,match", [
    (b"", "ends inside"), (b"\xc1", "not defined"), (b"\x80\x00", "after the msgpack"),
    (b"\xd4\x05\x00", "ext type 5"),
])
def test_data_that_is_not_flax_msgpack_is_refused(data, match, tmp_path):
    (tmp_path / "x.msgpack").write_bytes(data)
    with pytest.raises(ValueError, match=match):
        read_flax_msgpack(str(tmp_path / "x.msgpack"))


def test_a_chunked_array_of_the_wrong_size_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    tree = fser.msgpack_restore(fser.msgpack_serialize({"a": np.zeros(40, np.float32)}))
    assert isinstance(tree["a"], np.ndarray)
    raw = {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 41},
                 "chunks": {"0": np.zeros(40, np.float32)}}}
    import msgpack

    data = msgpack.packb(raw, default=fser._msgpack_ext_pack, strict_types=True)
    (tmp_path / "x.msgpack").write_bytes(data)
    with pytest.raises(ValueError, match="shape"):
        read_flax_msgpack(str(tmp_path / "x.msgpack"))


# ---------------------------------------------------------------------------
# predict_cli on a run the JAX package trained
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX train_cli run (1 epoch, tiny widths) on a synthetic SMD entity."""
    from mtad_gat_tpu.cli.train_cli import run_training

    root = tmp_path_factory.mktemp("jaxrun")
    proc = root / "data" / "ServerMachineDataset" / "processed"
    os.makedirs(proc)
    train, test, labels = synthetic_series(n_train=220, n_test=180, n_features=38, seed=9)
    for name, arr in (("machine-1-1_train.pkl", train), ("machine-1-1_test.pkl", test),
                      ("machine-1-1_test_label.pkl", labels.astype(np.float32))):
        with open(proc / name, "wb") as f:
            pickle.dump(arr, f)
    cfg = JaxRunConfig(dataset="SMD", group="1-1", lookback=8, bs=64, epochs=1,
                       feat_gat_embed_dim=4, time_gat_embed_dim=4, gru_hid_dim=8,
                       fc_hid_dim=8, fc_n_layers=1, recon_hid_dim=8, dropout=0.0,
                       log_tensorboard=False, data_root=str(root / "data"),
                       output_root=str(root / "output"))
    run = run_training(cfg, run_id="01012026_120000")
    return root, run


def _summary(run, name):
    with open(os.path.join(run, name)) as f:
        return json.load(f)


def _assert_same_summary(got, want):
    assert got.keys() == want.keys() == {"epsilon_result", "pot_result", "bf_result"}
    for method in want:
        assert got[method].keys() == want[method].keys()
        for k in want[method]:
            np.testing.assert_allclose(got[method][k], want[method][k], rtol=1e-4,
                                       err_msg=f"{method}.{k}")


def _predict_both(root, run, extra=()):
    """The JAX predict_cli, then the port's, on ``run``; their summaries."""
    from mtad_gat_tpu.cli import predict_cli as jax_cli
    from mtad_gat_tpu_torch.cli import predict_cli as port_cli

    argv = ["--dataset", "SMD", "--group", "1-1", "--model_id", os.path.basename(run),
            "--data_root", str(root / "data"), "--output_root", str(root / "output"), *extra]
    count = len([n for n in os.listdir(run) if n.startswith("summary")])
    with mock.patch.object(sys, "argv", ["predict.py", *argv, "--compile_cache", ""]):
        jax_cli.main()
    want = _summary(run, f"summary_{count}.txt")
    got = port_cli.main([*argv, "--device", "cpu"])
    assert got == _summary(run, f"summary_{count + 1}.txt")
    return got, want


def test_port_predict_cli_scores_a_jax_train_cli_run(jax_run):
    root, run = jax_run
    assert sorted(n for n in os.listdir(run) if n.startswith("model")) == ["model.msgpack"]
    got, want = _predict_both(root, run)
    _assert_same_summary(got, want)
    _assert_same_summary(got, _summary(run, "summary.txt"))


def test_predict_precedence_is_the_jax_packages(jax_run):
    """A directory holding model.msgpack and a model.pt of other weights:
    both packages score model.msgpack; with --torch_ckpt both score the
    model.pt; and the two give different summaries."""
    root, run = jax_run
    params = read_flax_msgpack(os.path.join(run, "model.msgpack"))["params"]
    other = jax.tree_util.tree_map(lambda x: x * 0.5 + 0.1, params)
    pt = os.path.join(run, "model.pt")
    save_torch_checkpoint(other, pt)
    try:
        got, want = _predict_both(root, run)
        _assert_same_summary(got, want)
        _assert_same_summary(got, _summary(run, "summary.txt"))
        got_pt, want_pt = _predict_both(root, run, ["--torch_ckpt", pt])
        _assert_same_summary(got_pt, want_pt)
        assert got_pt != got
    finally:
        os.remove(pt)
