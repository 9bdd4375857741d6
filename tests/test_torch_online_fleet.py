"""The port's fleet scorer against E solo scorers and the JAX fleet, on the CPU.

The JAX fleet fixture's sizes (``tests/test_online_fleet.py``: K 5 features,
window 12, 3 entities, hidden 8, dropout 0), the port at
``attention_impl="pallas", gru_impl="pallas"``, so that every fleet forward
runs the K1 and K3 custom ops under ``torch.func.vmap`` and their vmap
rules call the kernels' grouped plain versions (the tensors lie on the
CPU). The weights are the JAX fleet's stacked tree, split into E port
``state_dict``s by ``utils/weights.jax_stacked_params_to_state_dicts``.

- Port fleet against E port ``OnlineScorer``s, aligned and ragged chunks
  (an entity with zero rows included), under epsilon, spot and dspot with
  EWM smoothing: records within atol 1e-6 (one forward of the longest
  entity's batch against one of each entity's own: the same float32 math,
  batched otherwise), thresholds within rtol 1e-4 as below (a SPOT
  threshold is a GPD fit over the scores' peaks: scores 1e-8 apart moved
  it by 1.3e-5 relative here), alarms equal where the score lies more
  than 1e-6 from the threshold.
- Port fleet against the JAX ``OnlineFleetScorer`` on the same weights:
  scores within atol 1e-5, thresholds within rtol 1e-4, alarms equal where
  the score lies more than 1e-5 from the threshold
  (``tests/test_torch_online.py``'s tolerances).
- A mid-stream save and resume equals the uninterrupted run bit for bit,
  and a JAX fleet's state file (raw, and in ``serve_cli``'s wrapper)
  resumes in the port and continues the JAX fleet's records.
- Reordered labels, a wrong geometry and another smoothing span are
  refused.
- The kernels' grouped plain versions equal per-group calls; under vmap,
  weights that vmap does not batch included; each vmap rule runs once a
  layer a forward; vmap with gradients runs K1-res's op, at a tiled
  forward's N too, and under gradients at a graph whose backward takes
  the CHUNKED tile (item 7d).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.config import MTADGATConfig as JaxConfig
from mtad_gat_tpu.inference import OnlineFleetScorer as JaxFleet
from mtad_gat_tpu.models import MTADGAT as JaxMTADGAT
from mtad_gat_tpu_torch.config import MTADGATConfig
from mtad_gat_tpu_torch.inference import OnlineFleetScorer, OnlineScorer
from mtad_gat_tpu_torch.kernels import gat as kg
from mtad_gat_tpu_torch.kernels import gru as kgru
from mtad_gat_tpu_torch.models import MTADGAT
from mtad_gat_tpu_torch.utils.weights import (
    jax_params_to_state_dict,
    jax_stacked_params_to_state_dicts,
)

torch.set_num_threads(1)

K, W, E = 5, 12, 3
SOLO_ATOL = 1e-6
JAX_ATOL = 1e-5
THRESHOLD_RTOL = 1e-4
SPAN = 5
# points of the calibration stream: 188 scores arm each threshold (a SPOT fit
# over the two or three peaks of 28 scores moves by 1% when the scores move
# by 1e-6, in either package)
CALIBRATION = 200
METHODS = {"epsilon": {}, "spot": dict(q=1e-3, level=0.9), "dspot": dict(q=1e-3, drift_depth=10)}


def _kw():
    return dict(n_features=K, window_size=W, out_dim=K, gru_hid_dim=8, forecast_hid_dim=8,
                forecast_n_layers=1, recon_hid_dim=8, recon_n_layers=1, dropout=0.0)


@pytest.fixture(scope="module")
def fleet_weights():
    """The JAX fleet's model and stacked params (numpy leaves), and the
    port's E models loaded from them."""
    jmodel = JaxMTADGAT(JaxConfig(**_kw()))
    per_entity = [jmodel.init(jax.random.PRNGKey(s), jnp.zeros((1, W, K)))["params"]
                  for s in range(E)]
    stacked = jax.tree_util.tree_map(lambda *a: np.asarray(jnp.stack(a)), *per_entity)
    models = []
    for sd in jax_stacked_params_to_state_dicts(stacked):
        m = MTADGAT(MTADGATConfig(**_kw(), attention_impl="pallas", gru_impl="pallas"))
        m.load_state_dict(sd)
        models.append(m)
    return jmodel, stacked, models


def _streams(n, seed=2):
    return np.random.default_rng(seed).standard_normal((E, n, K)).astype(np.float32)


# ragged chunks of the 60-point streams: entity 1 brings nothing in the second
RAGGED = ([7, 3, 12], [5, 0, 9], [20, 30, 1], [28, 27, 38])


def _ragged(xs, cuts):
    starts = np.zeros(E, int)
    for sizes in cuts:
        yield [xs[e, starts[e]:starts[e] + n] for e, n in enumerate(sizes)]
        starts += sizes


def _port_fleet(models, **kw):
    return OnlineFleetScorer.from_models(models, W, K, smoothing_span=SPAN, **kw)


def _calibrate(fleet, train, method):
    recs = fleet.update_many(train)
    for e in range(E):
        fleet.fit_threshold(e, np.array([r["score"] for r in recs[e]]), method=method,
                            **METHODS[method])


def _field(records, key):
    return np.array([np.asarray(r[key], np.float64) for r in records])


def _assert_close(got, want, atol, threshold_rtol):
    """Records equal within ``atol``, thresholds within ``threshold_rtol``,
    alarms equal where the score lies more than ``atol`` from the
    threshold. Returns the points closer than that."""
    assert [r["t"] for r in got] == [r["t"] for r in want]
    for key in ("forecast", "recon", "a_score", "score", "score_raw"):
        np.testing.assert_allclose(_field(got, key), _field(want, key), atol=atol,
                                   err_msg=key)
    thr_got, thr_want = _field(got, "threshold"), _field(want, "threshold")
    np.testing.assert_allclose(thr_got, thr_want, rtol=threshold_rtol)
    away = np.abs(_field(want, "score") - thr_want) > atol
    np.testing.assert_array_equal(_field(got, "is_anomaly")[away],
                                  _field(want, "is_anomaly")[away])
    return int((~away).sum())


@pytest.mark.parametrize("ragged", [False, True], ids=["aligned", "ragged"])
@pytest.mark.parametrize("method", list(METHODS))
def test_fleet_equals_solo_scorers(method, ragged, fleet_weights):
    _, _, models = fleet_weights
    train, xs = _streams(CALIBRATION, seed=1), _streams(60)
    fleet = _port_fleet(models)
    _calibrate(fleet, train, method)
    if ragged:
        got = [[] for _ in range(E)]
        for chunk in _ragged(xs, RAGGED):
            for e, recs in enumerate(fleet.update_ragged(chunk)):
                got[e] += recs
    else:
        got = [a + b for a, b in zip(fleet.update_many(xs[:, :25]), fleet.update_many(xs[:, 25:]))]
    near = 0
    for e in range(E):
        solo = OnlineScorer(models[e], W, K, smoothing_span=SPAN)
        recs = solo.update_many(train[e])
        solo.fit_threshold(np.array([r["score"] for r in recs]), method=method,
                           **METHODS[method])
        if ragged:
            want = []
            for chunk in _ragged(xs, RAGGED):
                want += solo.update_many(chunk[e])
        else:
            want = solo.update_many(xs[e, :25]) + solo.update_many(xs[e, 25:])
        assert len(want) == 60 and all(r["entity"] == e for r in got[e])
        near += _assert_close(got[e], want, SOLO_ATOL, THRESHOLD_RTOL)
    assert near <= 2


@pytest.mark.parametrize("ragged", [False, True], ids=["aligned", "ragged"])
@pytest.mark.parametrize("method", ["epsilon", "spot"])
def test_fleet_equals_the_jax_fleet(method, ragged, fleet_weights):
    jmodel, stacked, models = fleet_weights
    train, xs = _streams(CALIBRATION, seed=1), _streams(60)
    jfleet = JaxFleet(jmodel, jax.tree_util.tree_map(jnp.asarray, stacked), E, W, K,
                      smoothing_span=SPAN)
    fleet = _port_fleet(models)
    for f in (jfleet, fleet):
        _calibrate(f, train, method)
    if ragged:
        want, got = [[] for _ in range(E)], [[] for _ in range(E)]
        for chunk in _ragged(xs, RAGGED):
            for acc, f in ((want, jfleet), (got, fleet)):
                for e, recs in enumerate(f.update_ragged(chunk)):
                    acc[e] += recs
    else:
        want, got = jfleet.update_many(xs), fleet.update_many(xs)
    near = sum(_assert_close(g, w, JAX_ATOL, THRESHOLD_RTOL) for g, w in zip(got, want))
    assert near <= 2


def test_mid_stream_resume_equals_uninterrupted(fleet_weights, tmp_path):
    _, _, models = fleet_weights
    train, xs = _streams(CALIBRATION, seed=1), _streams(60)
    whole = _port_fleet(models)
    _calibrate(whole, train, "spot")
    want = [a + b for a, b in zip(whole.update_many(xs[:, :30]), whole.update_many(xs[:, 30:]))]

    first = _port_fleet(models)
    first.labels = ["a", "b", "c"]
    _calibrate(first, train, "spot")
    head = first.update_many(xs[:, :30])
    path = str(tmp_path / "fleet.state")
    first.save_state(path)
    resumed = _port_fleet(models)
    resumed.load_state_file(path)
    assert resumed.labels == ["a", "b", "c"]
    tail = resumed.update_many(xs[:, 30:])
    for e in range(E):
        got = head[e] + tail[e]
        assert [r["t"] for r in got] == [r["t"] for r in want[e]]
        for key in ("score", "threshold", "is_anomaly"):
            assert [r[key] for r in got] == [r[key] for r in want[e]], key


@pytest.mark.parametrize("wrapped", [False, True], ids=["raw", "serve_cli"])
def test_a_jax_fleet_state_file_resumes_in_the_port(wrapped, fleet_weights, tmp_path):
    jmodel, stacked, models = fleet_weights
    train, xs = _streams(CALIBRATION, seed=1), _streams(60)
    jfleet = JaxFleet(jmodel, jax.tree_util.tree_map(jnp.asarray, stacked), E, W, K,
                      smoothing_span=SPAN)
    jfleet.labels = ["1-1", "1-2", "1-3"]
    _calibrate(jfleet, train, "spot")
    jfleet.update_many(xs[:, :30])
    path = tmp_path / "jax_fleet.state"
    if wrapped:
        with open(path, "wb") as f:
            pickle.dump({"scorer": jfleet.state_dict(), "input": ["a.csv"] * E,
                         "lines": [30] * E}, f)
    else:
        jfleet.save_state(str(path))
    want = jfleet.update_many(xs[:, 30:])
    fleet = _port_fleet(models)
    fleet.load_state_file(str(path))
    assert fleet.labels == ["1-1", "1-2", "1-3"]
    got = fleet.update_many(xs[:, 30:])
    near = sum(_assert_close(g, w, JAX_ATOL, THRESHOLD_RTOL) for g, w in zip(got, want))
    assert near <= 2


def _reordered(state):
    state["labels"] = ["b", "a", "c"]


def _geometry(state):
    state["window"] = W + 1


def _span(state):
    state["smoothing_span"] = SPAN + 1


@pytest.mark.parametrize("corrupt,match", [
    (_reordered, "same entities in the same order"),
    (_geometry, "geometry mismatch"),
    (_span, "smoothing_span"),
], ids=["reordered labels", "geometry", "smoothing span"])
def test_a_mismatched_state_is_refused(corrupt, match, fleet_weights):
    _, _, models = fleet_weights
    fleet = _port_fleet(models)
    fleet.labels = ["a", "b", "c"]
    fleet.update_many(_streams(3))
    state = fleet.state_dict()
    corrupt(state)
    other = _port_fleet(models)
    other.labels = ["a", "b", "c"]
    with pytest.raises(ValueError, match=match):
        other.load_state(state)


def test_the_fleet_refuses_bad_chunks_and_models(fleet_weights):
    _, _, models = fleet_weights
    fleet = _port_fleet(models)
    with pytest.raises(ValueError, match="n_entities=3"):
        fleet.update_many(_streams(4)[:2])
    with pytest.raises(ValueError, match="need 3 streams"):
        fleet.update_ragged([np.zeros((1, K))] * 2)
    with pytest.raises(ValueError, match="exceeds pad_to"):
        fleet.update_ragged([np.zeros((4, K))] * 3, pad_to=2)
    assert fleet.update_ragged([np.zeros((0, K))] * 3) == [[], [], []]
    assert fleet.forwards == 0
    other = MTADGAT(MTADGATConfig(**{**_kw(), "gru_hid_dim": 4}))
    with pytest.raises(ValueError, match="share one config"):
        OnlineFleetScorer.from_models([models[0], other], W, K)


def test_fleets_over_the_same_fresh_models():
    """``from_models`` puts every model in eval mode, so a second fleet over
    the same models (built in training mode) stacks them as the first did."""
    cfg = MTADGATConfig(**_kw(), attention_impl="pallas", gru_impl="pallas")
    models = [MTADGAT(cfg, generator=torch.Generator().manual_seed(s)) for s in range(E)]
    xs = _streams(W + 3)
    first, second = (OnlineFleetScorer.from_models(models, W, K) for _ in range(2))
    assert not any(m.training for m in models)
    for a, b in zip(first.update_many(xs), second.update_many(xs)):
        assert [r["score"] for r in a] == [r["score"] for r in b]


# ---------------------------------------------------------------------------
# The kernels' grouped plain versions and their vmap rules
# ---------------------------------------------------------------------------


def _k1_inputs(G=3, B=2, N=6, E_=8, D=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return (r(G * B, N, E_), r(G * B, N, E_), r(G, E_), 0.1 * r(G, N, N), r(G * B, N, D)), G, B


def _k3_inputs(G=3, B=2, T=5, H=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(G * B, T, 3 * H, generator=g),
            0.4 * torch.randn(G, H, 3 * H, generator=g),
            0.1 * torch.randn(G, 3 * H, generator=g)), G, B, H


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no bias"])
def test_grouped_plain_k1_equals_per_group_calls(with_bias):
    (p, q, a, bias, v), G, B = _k1_inputs()
    bias = bias if with_bias else None
    got = kg.gatv2_attention_fwd(p, q, a, bias, v, 0.2)
    for g in range(G):
        rows = slice(g * B, (g + 1) * B)
        want = kg.gatv2_attention_fwd_plain(p[rows], q[rows], a[g],
                                            None if bias is None else bias[g], v[rows], 0.2)
        assert torch.equal(got[rows], want)


def test_grouped_plain_k3_equals_per_group_calls():
    (gi, w, b), G, B, H = _k3_inputs()
    with torch.no_grad():
        got, last = kgru.gru_scan_fwd(gi, w, b, H)
        for g in range(G):
            rows = slice(g * B, (g + 1) * B)
            assert torch.equal(got[rows], kgru.gru_scan_fwd_plain(gi[rows], w[g], b[g], H)[0])
    assert torch.equal(last, got[:, -1])


@pytest.mark.parametrize("batched_weights", [True, False], ids=["stacked", "shared"])
def test_vmapped_k1_equals_per_entity_calls(batched_weights):
    (p, q, a, bias, v), G, B = _k1_inputs()
    if not batched_weights:
        a, bias = a[0], bias[0]
    dims = (0, 0, 0 if batched_weights else None, 0 if batched_weights else None, 0)
    before = kg._gatv2_attention_fwd_vmap.calls
    with torch.no_grad():
        got = torch.func.vmap(lambda *t: kg.gatv2_attention(*t, 0.2), in_dims=dims)(
            p.view(G, B, *p.shape[1:]), q.view(G, B, *q.shape[1:]), a, bias,
            v.view(G, B, *v.shape[1:]))
    assert kg._gatv2_attention_fwd_vmap.calls == before + 1
    for g in range(G):
        rows = slice(g * B, (g + 1) * B)
        want = kg.gatv2_attention_fwd_plain(p[rows], q[rows], a[g] if batched_weights else a,
                                            bias[g] if batched_weights else bias, v[rows], 0.2)
        torch.testing.assert_close(got[g], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("batched_weights", [True, False], ids=["stacked", "shared"])
def test_vmapped_k3_equals_per_entity_calls(batched_weights):
    (gi, w, b), G, B, H = _k3_inputs()
    if not batched_weights:
        w, b = w[0], b[0]
    dims = (0, 0, 0) if batched_weights else (0, None, None)
    before = kgru._gru_scan_fwd_vmap.calls
    with torch.no_grad():
        got = torch.func.vmap(lambda *t: kgru.gru_scan(*t, H)[0], in_dims=dims)(
            gi.view(G, B, *gi.shape[1:]), w, b)
    assert kgru._gru_scan_fwd_vmap.calls == before + 1
    for g in range(G):
        rows = slice(g * B, (g + 1) * B)
        want = kgru.gru_scan_fwd_plain(gi[rows], w[g] if batched_weights else w,
                                       b[g] if batched_weights else b, H)[0]
        torch.testing.assert_close(got[g], want, rtol=0, atol=1e-6)


def test_each_vmap_rule_runs_once_a_layer_a_forward(fleet_weights):
    """Feature and temporal attention: two K1 rules; encoder and decoder:
    two K3 rules, a fleet forward, whatever E is."""
    _, _, models = fleet_weights
    fleet = _port_fleet(models)
    before = (kg._gatv2_attention_fwd_vmap.calls, kgru._gru_scan_fwd_vmap.calls)
    fleet.update_ragged([x for x in _streams(4)])
    fleet.update_ragged([np.zeros((2, K)), np.zeros((0, K)), np.zeros((1, K))])
    assert fleet.forwards == 2
    assert (kg._gatv2_attention_fwd_vmap.calls - before[0],
            kgru._gru_scan_fwd_vmap.calls - before[1]) == (4, 4)


def test_vmap_with_gradients_raises_naming_item_7(fleet_weights):
    """Item 7b is done: the fleet's forward with gradients (weights that
    require them, under vmap) runs K1-res's op, whose rule calls the grouped
    plain version here, and equals the no-grad fleet forward (K1's op);
    its gradients are each model's own. The attention at dropout under vmap
    equals the per-entity calls (one seed, each entity's mask its own
    call's), and so it does at a graph the whole-graph kernels cannot hold
    (N 400 at E 8: the tiled forward, since item 7c). Under gradients a
    graph whose backward takes the CHUNKED tile runs too since item 7d,
    each entity's gradients its own call's."""
    _, _, models = fleet_weights
    params, buffers = torch.func.stack_module_state(models)
    base = models[0]

    def forward(prm, buf, x):
        return torch.func.functional_call(base, (prm, buf), (x,))[0]

    x = torch.from_numpy(_streams(W)[:, None].repeat(2, axis=1))
    rules = kg._gatv2_attention_res_vmap.calls
    out = torch.func.vmap(forward)(params, buffers, x)
    assert kg._gatv2_attention_res_vmap.calls - rules == 2
    with torch.no_grad():
        plain = torch.func.vmap(forward)(params, buffers, x)
    torch.testing.assert_close(out, plain, rtol=0, atol=SOLO_ATOL)
    out.sum().backward()
    models[1].zero_grad()
    models[1](x[1])[0].sum().backward()
    grads = {n: t.grad for n, t in models[1].named_parameters() if t.grad is not None}
    assert {"feature_gat.a", "temporal_gat.a", "temporal_gat.bias"} <= set(grads)
    for name, want in grads.items():
        torch.testing.assert_close(params[name].grad[1], want, rtol=1e-5, atol=1e-6,
                                   msg=name)
    models[1].zero_grad()

    (p, q, a, bias, v), G, B = _k1_inputs()
    ent = lambda t: t.view(G, B, *t.shape[1:])  # noqa: E731
    got = torch.func.vmap(lambda *t: kg.gatv2_attention(*t, 0.2, 0, 0.3))(
        ent(p), ent(q), a, bias, ent(v))
    for g in range(G):
        want = kg.gatv2_attention(ent(p)[g], ent(q)[g], a[g], bias[g], ent(v)[g], 0.2, 0, 0.3)
        assert torch.equal(got[g], want)
    gen = torch.Generator().manual_seed(1)
    wide, v_wide = torch.randn(G, 1, 400, 8, generator=gen), torch.randn(G, 1, 400, 4,
                                                                         generator=gen)
    assert kg.gat_fwd_plan(400, 8, 4) == "tiled"
    attend = lambda p_e, a_e, v_e: kg.gatv2_attention(p_e, p_e, a_e, None, v_e,  # noqa: E731
                                                      0.2, 0, 0.3)
    got = torch.func.vmap(attend)(wide, a, v_wide)
    for g in range(G):
        assert torch.equal(got[g], attend(wide[g], a[g], v_wide[g]))
    chunked, v_chunked = (torch.randn(G, 1, 65, 600, generator=gen),
                          torch.randn(G, 1, 65, 300, generator=gen))
    a_chunked = 0.1 * torch.randn(G, 600, generator=gen)
    summed = lambda p_e, a_e, v_e: attend(p_e, a_e, v_e).sum()  # noqa: E731
    got = torch.func.vmap(torch.func.grad(summed, argnums=(0, 1)))(chunked, a_chunked, v_chunked)
    for g in range(G):
        want = torch.func.grad(summed, argnums=(0, 1))(chunked[g], a_chunked[g], v_chunked[g])
        for x, w in zip(got, want):
            torch.testing.assert_close(x[g], w, rtol=0, atol=1e-6)


def test_stacked_jax_params_split_by_entity(fleet_weights):
    jmodel, stacked, models = fleet_weights
    one = jax.tree_util.tree_map(lambda x: x[1], stacked)
    sd = jax_params_to_state_dict(one)
    for k, t in models[1].state_dict().items():
        assert torch.equal(t, sd[k]), k
    with pytest.raises(ValueError, match="one entity axis"):
        jax_stacked_params_to_state_dicts({"a": {"x": np.zeros((2, 3))}, "b": np.zeros((3,))})


# ---------------------------------------------------------------------------
# The grouped launch arithmetic (K3's tiles, K1's and K3's group checks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,groups,tile", [
    (1, 28, 12), (128, 28, 12), (13, 5, 8), (12, 3, 12), (1, 28, 8), (128, 28, 8),
    (100, 1, 12),
])
def test_group_tiles_never_straddle_a_group(rows, groups, tile):
    """K3's batch tiles (a cluster's, or a streaming block's): ceil(rows /
    tile) a group, each within one group, together covering every row once;
    one group is the ungrouped tiling."""
    tiles = kgru.group_tiles(rows, groups, tile)
    assert len(tiles) == groups * -(-rows // tile)
    covered = []
    for g, first, n in tiles:
        assert 1 <= n <= tile
        assert g * rows <= first and first + n <= (g + 1) * rows
        covered += range(first, first + n)
    assert covered == list(range(groups * rows))
    if groups == 1:
        assert [first for _, first, _ in tiles] == list(range(0, rows, tile))


@pytest.mark.parametrize("a_shape,bias_shape,B,groups", [
    ((8,), (6, 6), 6, 1), ((8,), None, 6, 1), ((3, 8), (3, 6, 6), 6, 3),
    ((3, 8), None, 6, 3), ((1, 8), (1, 6, 6), 6, 1), ((6, 8), (6, 6, 6), 6, 6),
    ((4, 8), (4, 6, 6), 6, None), ((3, 8), (6, 6), 6, None), ((3, 8), (2, 6, 6), 6, None),
    ((3, 7), (3, 6, 6), 6, None), ((8,), (3, 6, 6), 6, None),
])
def test_k1_groups_accept_grouped_shapes_only_where_they_divide_the_batch(
        a_shape, bias_shape, B, groups):
    """``attention_groups``, the rule ``_check`` applies to a K1 launch: a
    (G, E) and bias (G, N, N) where G divides the batch; anything else
    raises."""
    p = torch.zeros(B, 6, 8)
    a = torch.zeros(a_shape)
    bias = None if bias_shape is None else torch.zeros(bias_shape)
    if groups is None:
        with pytest.raises(ValueError, match="multiple of G"):
            kg.attention_groups(p, a, bias, "K1")
    else:
        assert kg.attention_groups(p, a, bias, "K1") == groups


@pytest.mark.parametrize("w_shape,b_shape,B,groups", [
    ((6, 18), (18,), 4, 1), ((2, 6, 18), (2, 18), 4, 2), ((4, 6, 18), (4, 18), 4, 4),
    ((1, 6, 18), (1, 18), 4, 1), ((3, 6, 18), (3, 18), 4, None), ((2, 6, 18), (18,), 4, None),
    ((2, 6, 18), (3, 18), 4, None), ((2, 5, 18), (2, 18), 4, None),
])
def test_k3_groups_accept_grouped_shapes_only_where_they_divide_the_batch(
        w_shape, b_shape, B, groups):
    if groups is None:
        with pytest.raises(ValueError, match="multiple of G"):
            kgru.weight_groups(B, torch.zeros(w_shape), torch.zeros(b_shape), 6, "K3")
    else:
        assert kgru.weight_groups(B, torch.zeros(w_shape), torch.zeros(b_shape), 6, "K3") \
            == groups
