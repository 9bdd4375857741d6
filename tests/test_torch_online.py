"""The port's streaming scorer against the JAX package's, on the CPU.

Both scorers get the same weights (a JAX init loaded into the port through
``jax_params_to_state_dict``) and the same stream. The port runs its kernel
path (``attention_impl`` and ``gru_impl`` "pallas": on CPU tensors the
kernels' plain versions), the JAX scorer its plain ops. Tolerances:

- ``forecast``, ``recon``, ``a_score`` and ``score`` within atol 1e-5, as
  ``test_torch_predict.py`` holds ``get_score``: the same float32 forward
  summed in another order, on values of order 1;
- spot and dspot thresholds within rtol 1e-4: functions of scores that
  agree to about 1e-6;
- alarms equal wherever the score lies more than 1e-5 from the threshold;
  the number of points closer than that is asserted, not hidden.

On the port alone: its records equal its own offline ``get_score`` (atol
1e-5); ``update_many`` equals per-point ``update`` (atol 1e-6: one forward
of batch K against K of batch 1) and ``pad_to`` changes no bit; the EWM is
pandas' bit for bit, NaN included; ``fit_threshold`` restarts it; a saved
state resumes bit for bit; the host-only scorer raises. A state file the
JAX scorer wrote resumes in the port, in a process that loads no
``mtad_gat_tpu.`` module, and continues the JAX scorer's records.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.data import synthetic_series
from mtad_gat_tpu.inference import OnlineScorer as JaxOnlineScorer
from mtad_gat_tpu.models import MTADGAT as JaxMTADGAT
from mtad_gat_tpu_torch.config import MTADGATConfig
from mtad_gat_tpu_torch.inference import OnlineScorer, Predictor
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
K, W = 5, 12
ATOL = 1e-5
THRESHOLD_RTOL = 1e-4
NEAR = 1e-5
CHUNK = 40


def _cfg_kw(out_dim=K):
    return dict(n_features=K, window_size=W, out_dim=out_dim, gru_hid_dim=16,
                forecast_hid_dim=16, forecast_n_layers=1, recon_hid_dim=16,
                recon_n_layers=1, dropout=0.0)


def _models(out_dim=K, seed=0):
    jmodel = JaxMTADGAT(JaxConfig(**_cfg_kw(out_dim), attention_impl="dense", gru_impl="xla"))
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, W, K)))["params"]
    model = MTADGAT(MTADGATConfig(**_cfg_kw(out_dim), attention_impl="pallas",
                                  gru_impl="pallas"))
    model.load_state_dict(jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, model


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def series():
    train, test, _ = synthetic_series(n_train=300, n_test=120, n_features=K, seed=2)
    return train, test


@pytest.fixture(scope="module")
def train_scores(models, series):
    """Calibration scores, the JAX scorer's replay of the train series."""
    jmodel, params, _ = models
    recs = JaxOnlineScorer(jmodel, params, W, K).update_many(series[0])
    return np.array([r["score"] for r in recs])


def _chunks(scorer, xs, size=CHUNK):
    out = []
    for i in range(0, len(xs), size):
        out += scorer.update_many(xs[i:i + size])
    return out


def _field(records, key):
    return np.array([np.asarray(r[key]) for r in records])


def _assert_records_close(got, want, alarms=True):
    assert [r["t"] for r in got] == [r["t"] for r in want]
    for key in ("forecast", "recon", "a_score", "score"):
        np.testing.assert_allclose(_field(got, key), _field(want, key), atol=ATOL, err_msg=key)
    if not alarms:
        return 0
    thr_got, thr_want = _field(got, "threshold"), _field(want, "threshold")
    np.testing.assert_allclose(thr_got, thr_want, rtol=THRESHOLD_RTOL)
    near = np.abs(_field(want, "score") - thr_want) <= NEAR
    away = ~near
    np.testing.assert_array_equal(_field(got, "is_anomaly")[away],
                                  _field(want, "is_anomaly")[away])
    return int(near.sum())


@pytest.mark.parametrize("method,kw", [
    ("epsilon", {}),
    ("spot", dict(q=1e-3, level=0.9)),
    ("dspot", dict(q=1e-3, drift_depth=100)),
])
def test_records_equal_the_jax_scorer(method, kw, models, series, train_scores):
    jmodel, params, model = models
    want_s = JaxOnlineScorer(jmodel, params, W, K)
    got_s = OnlineScorer(model, W, K)
    for s in (want_s, got_s):
        s.fit_threshold(train_scores, method=method, **kw)
        _chunks(s, series[0][-W:])               # prime with the train tail
    want, got = _chunks(want_s, series[1]), _chunks(got_s, series[1])
    assert len(got) == len(series[1])
    near = _assert_records_close(got, want)
    assert near == 0, f"{near} points lie within {NEAR} of the threshold"
    assert any(r["is_anomaly"] for r in want), "the stream raises no alarm"
    if method != "epsilon":
        assert len({r["threshold"] for r in want}) > 1


def test_records_equal_the_ports_get_score(models, series, tmp_path):
    _, _, model = models
    test = series[1]
    offline = Predictor(model, W, K, {
        "dataset": "SMD", "target_dims": None, "scale_scores": False, "q": 1e-3,
        "level": 0.98, "dynamic_pot": False, "use_mov_av": False, "gamma": 1.0,
        "reg_level": 1, "save_path": str(tmp_path)}, batch_size=16).get_score(test)
    records = OnlineScorer(model, W, K).update_many(test)
    assert [r["t"] for r in records] == list(range(W, len(test)))
    np.testing.assert_allclose(_field(records, "score"), offline["A_Score_Global"], atol=ATOL)
    for i in range(K):
        for key, col in (("forecast", "Forecast"), ("recon", "Recon"), ("a_score", "A_Score")):
            np.testing.assert_allclose(_field(records, key)[:, i],
                                       offline[f"{col}_{i}"].to_numpy(), atol=ATOL,
                                       err_msg=f"{col}_{i}")


def test_update_many_equals_update_and_pad_to_changes_no_bit(models, series, train_scores):
    """Chunks across the warm-up boundary, of size 1 and clipped at the end,
    against per-point updates; then pad_to against no pad_to."""
    _, _, model = models
    test = series[1][:70]
    a, b = OnlineScorer(model, W, K), OnlineScorer(model, W, K)
    for s in (a, b):
        s.fit_threshold(train_scores, method="spot", q=1e-3, level=0.9)
    per_point = [r for x in test if (r := a.update(x)) is not None]
    chunked, i = [], 0
    for size in (5, 1, W, 3, 1000):
        chunked += b.update_many(test[i:i + size])
        i += size
    assert len(per_point) == len(chunked) == len(test) - W
    for ra, rb in zip(per_point, chunked):
        assert ra["t"] == rb["t"]
        for key in ("score", "forecast", "recon", "a_score"):
            np.testing.assert_allclose(rb[key], ra[key], atol=1e-6, err_msg=key)
        assert ra["is_anomaly"] == rb["is_anomaly"]
        np.testing.assert_allclose(rb["threshold"], ra["threshold"], rtol=1e-9)

    c, d = OnlineScorer(model, W, K), OnlineScorer(model, W, K)
    rc = c.update_many(test[:30]) + c.update_many(test[30:])
    rd = d.update_many(test[:30], pad_to=30) + d.update_many(test[30:], pad_to=64)
    np.testing.assert_array_equal(_field(rc, "score"), _field(rd, "score"))
    assert torch.equal(c._buffer, d._buffer)
    assert torch.equal(c._pending_forecast, d._pending_forecast)
    with pytest.raises(ValueError, match="pad_to"):
        d.update_many(test[:9], pad_to=8)


def test_target_dims_equal_the_jax_scorer(series):
    jmodel, params, model = _models(out_dim=2, seed=1)
    want = JaxOnlineScorer(jmodel, params, W, K, target_dims=[0, 3]).update_many(series[1])
    got = OnlineScorer(model, W, K, target_dims=[0, 3]).update_many(series[1])
    assert got[0]["a_score"].shape == (2,)
    _assert_records_close(got, want, alarms=False)


def test_streaming_ewm_equals_pandas(models, series):
    """Record for record, bit for bit: the chunked and the per-point path
    against pandas' ewm over the raw scores each streamed."""
    _, _, model = models
    test, span = series[1], 7
    raw = _field(OnlineScorer(model, W, K).update_many(test), "score")
    sm = OnlineScorer(model, W, K, smoothing_span=span)
    got = [r for i in range(0, len(test), 17) for r in sm.update_many(test[i:i + 17])]
    sm2 = OnlineScorer(model, W, K, smoothing_span=span)
    got2 = [r for x in test if (r := sm2.update(x)) is not None]
    for records in (got, got2):
        np.testing.assert_allclose(_field(records, "score_raw"), raw, atol=1e-6)
        want = pd.Series(_field(records, "score_raw")).ewm(span=span).mean().to_numpy()
        np.testing.assert_array_equal(_field(records, "score"), want)


@pytest.mark.parametrize("span,nan_at", [(7, [5, 50, 51]), (7, [0]), (13, list(range(6)))],
                         ids=["gaps", "seed", "prefix"])
def test_streaming_ewm_nan_follows_pandas(span, nan_at):
    vals = np.random.default_rng(3).standard_normal(150)
    vals[nan_at] = np.nan
    scorer = OnlineScorer(None, W, K, smoothing_span=span)
    got = np.array([scorer._smooth_score(v) for v in vals])
    want = pd.Series(vals).ewm(span=span, adjust=True).mean().to_numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[finite], want[finite])


def test_fit_threshold_restarts_the_ewm(models, series):
    _, _, model = models
    train, test = series
    span = 9
    sm = OnlineScorer(model, W, K, smoothing_span=span)
    train_records = sm.update_many(train)              # the EWM advanced
    sm.fit_threshold(_field(train_records, "score"), method="epsilon")
    got = _field(sm.update_many(test), "score")
    raw = OnlineScorer(model, W, K)
    raw.update_many(train)
    want = pd.Series(_field(raw.update_many(test), "score")).ewm(span=span).mean().to_numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["spot", "dspot"])
def test_save_and_load_resume_bit_for_bit(method, models, series, train_scores, tmp_path):
    _, _, model = models
    kw = dict(q=1e-3, level=0.9) if method == "spot" else dict(q=1e-3, drift_depth=100)

    def armed():
        s = OnlineScorer(model, W, K, smoothing_span=6)
        s.fit_threshold(train_scores, method=method, **kw)
        s.update_many(series[0][-W:])
        return s

    want = armed().update_many(series[1])
    part = armed()
    first = part.update_many(series[1][:37])
    path = str(tmp_path / "scorer.state")
    part.save_state(path)
    resumed = OnlineScorer(model, W, K, smoothing_span=6)
    resumed.load_state_file(path)
    got = first + resumed.update_many(series[1][37:])
    assert [r["t"] for r in got] == [r["t"] for r in want]
    for key in ("score", "threshold", "is_anomaly", "a_score"):
        np.testing.assert_array_equal(_field(got, key), _field(want, key), err_msg=key)
    with pytest.raises(ValueError, match="smoothing_span"):
        OnlineScorer(model, W, K).load_state_file(path)


def test_host_only_scorer_raises(series):
    s = OnlineScorer(None, W, K, gamma=1.0)
    s.fit_threshold(np.abs(np.random.default_rng(0).standard_normal(200)), method="epsilon")
    for call in (lambda: s.update(series[1][0]), lambda: s.update_many(series[1][:3])):
        with pytest.raises(RuntimeError, match="model=None"):
            call()
    assert s.state_dict()["buffer"] is None


_RESUME = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from mtad_gat_tpu_torch.config import MTADGATConfig
from mtad_gat_tpu_torch.inference import OnlineScorer
from mtad_gat_tpu_torch.models import MTADGAT
cfg, weights, state, stream, out = sys.argv[1:6]
model = MTADGAT(MTADGATConfig(**json.loads(cfg)))
model.load_state_dict(torch.load(weights))
scorer = OnlineScorer(model, %d, %d)
scorer.load_state_file(state)
loaded = sorted(m for m in sys.modules if m == "mtad_gat_tpu" or m.startswith("mtad_gat_tpu."))
recs = scorer.update_many(np.load(stream))
np.savez(out, t=[r["t"] for r in recs], score=[r["score"] for r in recs],
         threshold=[r["threshold"] for r in recs],
         is_anomaly=[r["is_anomaly"] for r in recs],
         spot_class=type(scorer._spot).__module__ + "." + type(scorer._spot).__name__)
print(json.dumps(loaded))
""" % (W, K)


@pytest.mark.parametrize("method,kw", [
    ("spot", dict(q=1e-3, level=0.9)),
    ("dspot", dict(q=1e-3, drift_depth=100)),
])
def test_a_jax_state_file_resumes_in_the_port(method, kw, models, series, train_scores,
                                              tmp_path):
    jmodel, params, model = models
    jax_scorer = JaxOnlineScorer(jmodel, params, W, K)
    jax_scorer.fit_threshold(train_scores, method=method, **kw)
    _chunks(jax_scorer, series[0][-W:])
    _chunks(jax_scorer, series[1][:50])
    state = tmp_path / "jax.state"
    jax_scorer.save_state(str(state))
    want = _chunks(jax_scorer, series[1][50:])

    weights, stream, out = tmp_path / "model.pt", tmp_path / "rest.npy", tmp_path / "rest.npz"
    torch.save(model.state_dict(), weights)
    np.save(stream, series[1][50:])
    cfg = json.dumps(dict(_cfg_kw(), attention_impl="pallas", gru_impl="pallas"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _RESUME, cfg, str(weights), str(state),
                          str(stream), str(out)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    got = np.load(out)
    cls = "dSPOT" if method == "dspot" else "SPOT"
    assert str(got["spot_class"]) == f"mtad_gat_tpu_torch.inference.spot.{cls}"
    np.testing.assert_array_equal(got["t"], [r["t"] for r in want])
    np.testing.assert_allclose(got["score"], _field(want, "score"), atol=ATOL)
    np.testing.assert_allclose(got["threshold"], _field(want, "threshold"),
                               rtol=THRESHOLD_RTOL)
    away = np.abs(_field(want, "score") - _field(want, "threshold")) > NEAR
    assert away.all(), f"{(~away).sum()} points lie within {NEAR} of the threshold"
    np.testing.assert_array_equal(got["is_anomaly"], _field(want, "is_anomaly"))


def test_a_state_naming_other_jax_classes_is_refused(tmp_path):
    import pickle

    path = tmp_path / "bad.state"
    path.write_bytes(pickle.dumps({"scorer": JaxConfig(), "lines": 0}))
    s = OnlineScorer(None, W, K)
    with pytest.raises(pickle.UnpicklingError, match="mtad_gat_tpu.config.MTADGATConfig"):
        s.load_state_file(str(path))
