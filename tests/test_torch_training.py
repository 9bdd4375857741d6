"""The port's training path against the JAX package's, on the CPU.

- Model gradients: the port's ``MTADGAT`` on a JAX init, in training mode at
  dropout 0, attention "pallas" (the kernels' plain versions behind the
  autograd Function) and "dense", and attention and GRU both "pallas" (the
  JAX side then differentiates through its Pallas attention and BPTT kernels
  in interpret mode): the loss of ``make_loss_fn`` and every
  parameter's gradient agree with ``jax.grad`` of the JAX loss, atol 1e-4
  (the forward's tolerance in ``test_torch_model.py``: the same float32 math
  summed in other orders).
- Trainer trajectory: from the same init at dropout 0, on a 200-row series
  with a shuffled 0.1 validation split (11 steps of 16), the port's
  ``Trainer`` and the JAX ``Trainer`` give per-epoch losses and final params
  allclose to atol 2e-4, as ``tests/test_train_trajectory_parity.py`` holds
  the JAX trainer to torch: default Adam, global-norm clip 0.5, and the
  warmup-cosine schedule; once more with attention and GRU "pallas" on both
  sides.
- Resume: 3 epochs straight, and 1 epoch + save + ``load_full`` + fit, at
  dropout 0.3 through the attention kernels' plain versions, give
  bit-identical params and the same loss history, with the GRU scan (what
  ``gru_impl="auto"`` resolves to) and with the plain GRU loop.
- ``train_cli`` end to end (``--device cpu``, tiny widths, 1 epoch): the run
  directory holds model.pt, train_state.pt, config.txt and summary.txt, and
  the port's ``predict_cli`` on it reproduces summary.txt; also with
  ``--gru_impl pallas``, and with ``--use_cuda False`` in place of
  ``--device cpu`` (the reference's way to ask for the CPU).
- The device rule of both entry points (``cli/args.resolve_device``).
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.config import TrainConfig as JaxTrainConfig
from mtad_gat_tpu.models import MTADGAT as JaxMTADGAT
from mtad_gat_tpu.training import Trainer as JaxTrainer
from mtad_gat_tpu.training.trainer import make_loss_fn as jax_make_loss_fn
from mtad_gat_tpu_torch.cli import predict_cli, train_cli
from mtad_gat_tpu_torch.config import MTADGATConfig, TrainConfig
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.training import Trainer, make_loss_fn
from mtad_gat_tpu_torch.training.trainer import learning_rate
from mtad_gat_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

K, W = 5, 12


def _model_kw(**over):
    kw = dict(n_features=K, window_size=W, out_dim=K, gru_hid_dim=16,
              forecast_hid_dim=16, forecast_n_layers=2, recon_hid_dim=16,
              recon_n_layers=1, dropout=0.0)
    kw.update(over)
    return kw


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _series(n=200, seed=0):
    return np.random.default_rng(seed).standard_normal((n, K)).astype(np.float32)


def _assert_params_close(model, jax_params, atol):
    want = jax_params_to_state_dict(_np_tree(jax_params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), want[k].numpy(),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("impl,gru_impl", [("pallas", "xla"), ("dense", "xla"),
                                           ("pallas", "pallas")],
                         ids=["pallas", "dense", "pallas-gru_pallas"])
def test_loss_and_gradients_match_jax(impl, gru_impl):
    jmodel = JaxMTADGAT(JaxConfig(**_model_kw(attention_impl=impl, gru_impl=gru_impl)))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, W, K)))["params"]
    series = _series(60)
    starts = np.arange(0, 48, 6)[:8]
    mask = np.ones(8, np.float32)
    mask[-1] = 0.0                                 # a padded slot, as a tail batch has

    jloss = jax_make_loss_fn(jmodel, W, 1, None)
    (want_loss, _), want_grads = jax.value_and_grad(jloss, has_aux=True)(
        params, jnp.asarray(series), jnp.asarray(starts, jnp.int32), jnp.asarray(mask),
        jax.random.PRNGKey(1), False)

    model = MTADGAT(MTADGATConfig(**_model_kw(attention_impl=impl, gru_impl=gru_impl)))
    model.load_state_dict(jax_params_to_state_dict(_np_tree(params)))
    loss_fn = make_loss_fn(model, W, 1, None)
    loss, _ = loss_fn(torch.from_numpy(series), torch.from_numpy(starts),
                      torch.from_numpy(mask), torch.Generator(), False)
    assert model.training
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-4)
    want = jax_params_to_state_dict(_np_tree(want_grads))
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("extra,jax_impls", [
    (dict(), dict()),
    (dict(grad_clip_norm=0.5), dict()),
    (dict(lr_schedule="warmup_cosine", lr_warmup_steps=4, lr_decay_steps=9), dict()),
    (dict(), dict(attention_impl="pallas", gru_impl="pallas")),
], ids=["adam", "clip", "warmup_cosine", "adam-both_pallas"])
def test_trainer_tracks_jax_trainer(extra, jax_impls, tmp_path):
    mkw = _model_kw(attention_impl="pallas", **{k: v for k, v in jax_impls.items()
                                                if k == "gru_impl"})
    tkw = dict(epochs=1, val_split=0.1, bs=16, init_lr=1e-3, shuffle_dataset=True,
               log_tensorboard=False, seed=3, **extra)
    jt = JaxTrainer(JaxConfig(**_model_kw(**jax_impls)), JaxTrainConfig(**tkw),
                    log_dir=str(tmp_path / "jax"))
    jt.init_state()
    series = _series()
    pt = Trainer(MTADGATConfig(**mkw), TrainConfig(**tkw), log_dir=str(tmp_path / "port"),
                 device="cpu")
    pt.init_state()
    pt.model.load_state_dict(jax_params_to_state_dict(_np_tree(jt.state.params)))

    jt.fit(series)
    pt.fit(series)
    assert pt.step == int(jt.state.step) == 11
    for key, want in jt.losses.items():
        np.testing.assert_allclose(pt.losses[key], want, atol=2e-4, err_msg=key)
    _assert_params_close(pt.model, jt.state.params, atol=2e-4)


def test_learning_rate_schedules_match_optax():
    import optax

    for cfg, sched in (
        (TrainConfig(lr_schedule="cosine", lr_decay_steps=7),
         optax.cosine_decay_schedule(1e-3, 7)),
        (TrainConfig(lr_schedule="warmup_cosine", lr_warmup_steps=3, lr_decay_steps=10),
         optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 10)),
    ):
        for step in range(13):
            assert learning_rate(cfg, step) == pytest.approx(float(sched(step)),
                                                             rel=1e-6, abs=1e-12)


def test_resume_is_bit_exact(tmp_path):
    _check_resume("auto", tmp_path)      # the GRU scan, as "auto" resolves


def test_resume_is_bit_exact_with_the_plain_gru_loop(tmp_path):
    _check_resume("xla", tmp_path)


def _check_resume(gru_impl, tmp_path):
    mc = MTADGATConfig(**_model_kw(attention_impl="pallas", dropout=0.3,
                                   forecast_n_layers=2, gru_impl=gru_impl))
    tc3 = TrainConfig(epochs=3, val_split=0.0, bs=16, init_lr=1e-3,
                      log_tensorboard=False, seed=0, checkpoint_every=1)
    series = _series(140)

    full = Trainer(mc, tc3, log_dir=str(tmp_path / "l1"), device="cpu")
    full.fit(series)

    save = tmp_path / "run"
    first = Trainer(mc, dataclasses.replace(tc3, epochs=1), save_path=str(save),
                    log_dir=str(tmp_path / "l2"), device="cpu")
    first.fit(series)
    resumed = Trainer(mc, tc3, log_dir=str(tmp_path / "l3"), device="cpu")
    resumed.load_full(str(save / "train_state.pt"))
    resumed.fit(series)

    a, b = full.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.losses["train_total"] == full.losses["train_total"][1:]
    # and dropout was on: the first epoch's loss differs at dropout 0
    nodrop = Trainer(dataclasses.replace(mc, dropout=0.0), dataclasses.replace(tc3, epochs=1),
                     log_dir=str(tmp_path / "l4"), device="cpu")
    nodrop.fit(series)
    assert nodrop.losses["train_total"][0] != full.losses["train_total"][0]


def _write_smd(root, n=260, k=38):
    rng = np.random.default_rng(0)
    base = (np.sin(np.linspace(0, 20, n))[:, None] * rng.uniform(.5, 1.5, k)
            + rng.standard_normal((n, k)) * .1)
    test = base.copy()
    test[150:170] += 3.0
    label = np.zeros(n, np.float32)
    label[150:170] = 1
    d = os.path.join(root, "ServerMachineDataset", "processed")
    os.makedirs(d, exist_ok=True)
    for name, arr in (("machine-1-1_train", base.astype(np.float32)),
                      ("machine-1-1_test", test.astype(np.float32)),
                      ("machine-1-1_test_label", label)):
        with open(os.path.join(d, f"{name}.pkl"), "wb") as f:
            pickle.dump(arr, f)


TINY = ["--lookback", "8", "--feat_gat_embed_dim", "4", "--time_gat_embed_dim", "4",
        "--gru_hid_dim", "8", "--fc_hid_dim", "8", "--fc_n_layers", "1",
        "--recon_hid_dim", "8", "--bs", "64", "--epochs", "1",
        "--log_tensorboard", "False", "--device", "cpu"]


def test_train_cli_end_to_end_then_predict_cli(tmp_path):
    _check_train_then_predict(tmp_path, [])


def test_train_cli_with_the_gru_scan_end_to_end_then_predict_cli(tmp_path):
    run = _check_train_then_predict(tmp_path, ["--gru_impl", "pallas"])
    with open(os.path.join(run, "config.txt")) as f:
        assert json.load(f)["gru_impl"] == "pallas"


def _check_train_then_predict(tmp_path, flags, tiny=TINY, predict_flags=("--device", "cpu")):
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    _write_smd(data)
    common = ["--dataset", "SMD", "--group", "1-1", "--data_root", data, "--output_root", out]
    run = train_cli.main(common + tiny + flags
                         + ["--attention_impl", "pallas", "--run_id", "r1"])
    for name in ("model.pt", "train_state.pt", "config.txt", "summary.txt"):
        assert os.path.exists(os.path.join(run, name)), name
    with open(os.path.join(run, "summary.txt")) as f:
        trained = json.load(f)
    with open(os.path.join(out, "SMD", "1-1", "logs", "metrics.jsonl")) as f:
        assert json.loads(f.readline())["step"] == 0
    predict_cli.main(common + ["--model_id", "r1", *predict_flags])
    with open(os.path.join(run, "summary_1.txt")) as f:
        assert json.load(f) == trained
    return run


@pytest.mark.parametrize("flags,item", [
    (["--mesh_devices", "2"], "Queue 1 item 8"),
    (["--profile_dir", "prof"], "Queue 1 item 9"),
])
def test_train_cli_refuses_unported_paths(flags, item, tmp_path):
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    _write_smd(data)
    argv = (["--dataset", "SMD", "--data_root", data, "--output_root", out]
            + TINY + flags)
    with pytest.raises(NotImplementedError, match=item):
        train_cli.main(argv)


def test_train_cli_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--data_root", str(tmp_path), "--output_root", str(tmp_path)])


def test_train_cli_use_cuda_false_trains_on_the_cpu(tmp_path, monkeypatch):
    """The reference's --use_cuda False runs the whole pipeline on the CPU,
    even where no GPU exists, and predict_cli under the same flag
    reproduces its summary."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = TINY[:TINY.index("--device")]
    _check_train_then_predict(tmp_path, ["--use_cuda", "False"], tiny=tiny,
                              predict_flags=["--use_cuda", "False"])


@pytest.mark.parametrize("device,use_cuda,gpu,want", [
    (None, True, True, "cuda"), (None, False, True, "cpu"), (None, False, False, "cpu"),
    ("cpu", True, False, "cpu"), ("cpu", False, True, "cpu"), ("cuda:0", True, True, "cuda"),
    (None, True, False, RuntimeError), ("cuda", True, False, RuntimeError),
    ("cuda", False, True, ValueError), ("cuda", False, False, ValueError),
])
def test_resolve_device(device, use_cuda, gpu, want, monkeypatch):
    from mtad_gat_tpu_torch.cli.args import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpu)
    if isinstance(want, str):
        assert resolve_device(device, use_cuda).type == want
    else:
        with pytest.raises(want):
            resolve_device(device, use_cuda)


def test_clis_refuse_use_cuda_false_beside_device_cuda(tmp_path):
    argv = ["--data_root", str(tmp_path), "--output_root", str(tmp_path),
            "--use_cuda", "False", "--device", "cuda"]
    with pytest.raises(ValueError, match="--use_cuda False"):
        train_cli.main(argv)
    with pytest.raises(ValueError, match="--use_cuda False"):
        predict_cli.main(argv)

