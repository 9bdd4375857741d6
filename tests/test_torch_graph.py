"""The port's graph variants against the JAX package's, on the CPU.

``graph/structure.py`` (complete, COO, banded and k-NN topologies),
``graph/segment.py`` and the banded and COO paths of ``graph/ops.py``: the
same inputs, made with numpy from a seed, go through the JAX function and
the port's. Topologies and edge lists must be equal. Attention outputs and
their gradients (under a random cotangent, with respect to every input)
must agree within 1e-5 in float32 at dropout 0: both sides run the same
float32 math summed in other orders, a few 1e-7 apart at these sizes, while
a wrong offset, shear or mask moves them by 1e-2 or more.

The block scan's dropout is a hash of (seed, batch, i, j), so the steps
that ``torch.utils.checkpoint`` recomputes in the backward pass draw the
mask they drew forward; the last test holds its gradients with recompute
against those without at dropout 0.3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtad_gat_tpu.graph as jg
import mtad_gat_tpu.graph.ops as jops
import mtad_gat_tpu_torch.graph as tg
import mtad_gat_tpu_torch.graph.ops as tops

torch.set_num_threads(1)

TOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def _same_graph(tgraph, jgraph):
    assert tgraph.n_nodes == jgraph.n_nodes
    np.testing.assert_array_equal(tgraph.src.numpy(), np.asarray(jgraph.src))
    np.testing.assert_array_equal(tgraph.dst.numpy(), np.asarray(jgraph.dst))


@pytest.mark.parametrize("self_loops", [True, False])
def test_complete_and_banded_graphs_equal_jax(self_loops):
    _same_graph(tg.complete_graph(6, self_loops), jg.complete_graph(6, self_loops))
    for n, w in ((9, 2), (5, 7), (12, 0)):
        assert tg.banded_edges(n, w, self_loops) == jg.banded_edges(n, w, self_loops)
        _same_graph(tg.banded_graph(n, w, self_loops), jg.banded_graph(n, w, self_loops))


def test_graph_from_edges_sorts_by_destination_as_jax():
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 7, 30), rng.integers(0, 7, 30)
    _same_graph(tg.graph_from_edges(src, dst, 7), jg.graph_from_edges(src, dst, 7))
    with pytest.raises(ValueError):
        tg.graph_from_edges([0, 7], [1, 1], 7)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_knn_edges_equal_jax(k):
    rng = np.random.default_rng(k)
    series = rng.standard_normal((120, 6)).cumsum(axis=0)
    series[:, 4] = 1.0                              # a constant feature
    assert tg.knn_edges_from_series(series, k) == jg.knn_edges_from_series(series, k)


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------


def test_segment_ops_and_softmax_gradient_equal_jax():
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 6, 40))
    seg[seg == 3] = 2                               # segment 3 stays empty
    data = rng.standard_normal(40).astype(np.float32)
    cot = rng.standard_normal(40).astype(np.float32)
    ts = _t(seg).long()
    np.testing.assert_allclose(tg.segment_sum(_t(data), ts, 6).numpy(),
                               np.asarray(jg.segment_sum(data, seg, 6)), atol=TOL)
    np.testing.assert_array_equal(tg.segment_max(_t(data), ts, 6).numpy(),
                                  np.asarray(jg.segment_max(data, seg, 6)))

    x = _t(data).requires_grad_()
    got = tg.segment_softmax(x, ts, 6)
    (gx,) = torch.autograd.grad((got * _t(cot)).sum(), x)
    want, vjp = jax.vjp(lambda s: jg.segment_softmax(s, seg, 6), jnp.asarray(data))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), atol=TOL)


# ---------------------------------------------------------------------------
# attention: banded (unrolled and block scan) and COO, forward and gradients
# ---------------------------------------------------------------------------


def _inputs(seed, b, n, e, d, gatv2, bias_shape):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = {"p": f(b, n, e) if gatv2 else f(b, n), "q": f(b, n, e) if gatv2 else f(b, n),
         "v": f(b, n, d)}
    if gatv2:
        x["a"] = f(e) * 0.5
    if bias_shape is not None:
        x["bias"] = f(*bias_shape) * 0.3
    return x, f(b, n, d)


def _both(jax_fn, torch_fn, x, cot):
    """Outputs and input gradients of both functions under the cotangent."""
    names = sorted(x)
    want, vjp = jax.vjp(jax.jit(lambda *a: jax_fn(**dict(zip(names, a)))),
                        *[jnp.asarray(x[k]) for k in names])
    jgrads = vjp(jnp.asarray(cot))
    leaves = {k: _t(x[k]).requires_grad_() for k in names}
    got = torch_fn(**leaves)
    tgrads = torch.autograd.grad((got * _t(cot)).sum(), [leaves[k] for k in names])
    return names, (want, jgrads), (got, tgrads)


def _assert_close(names, want, got):
    (wout, wgrads), (gout, ggrads) = want, got
    np.testing.assert_allclose(gout.detach().numpy(), np.asarray(wout), atol=TOL, rtol=0)
    for k, wg, gg in zip(names, wgrads, ggrads):
        np.testing.assert_allclose(gg.numpy(), np.asarray(wg), atol=TOL, rtol=0, err_msg=k)


BANDED_CASES = [
    # (gatv2, n, bandwidth, bias_storage)
    (True, 11, 2, "full"), (True, 11, 3, "band"), (True, 6, 9, "band"),
    (False, 11, 2, "full"), (False, 10, 4, "band"), (True, 9, 3, None),
]


@pytest.mark.parametrize("gatv2,n,w,storage", BANDED_CASES)
def test_unrolled_banded_attention_matches_jax(gatv2, n, w, storage):
    bias_shape = None if storage is None else ((n, 2 * w + 1) if storage == "band" else (n, n))
    x, cot = _inputs(1, 2, n, 4, 3, gatv2, bias_shape)
    storage = storage or "full"
    if gatv2:
        jf = lambda p, q, a, v, bias=None: jops.gatv2_banded_attention(  # noqa: E731
            p, q, a, bias, v, 0.2, w, bias_storage=storage)
        tf = lambda p, q, a, v, bias=None: tops.gatv2_banded_attention(  # noqa: E731
            p, q, a, bias, v, 0.2, w, bias_storage=storage)
    else:
        jf = lambda p, q, v, bias=None: jops.gatv1_banded_attention(  # noqa: E731
            p, q, bias, v, 0.2, w, bias_storage=storage)
        tf = lambda p, q, v, bias=None: tops.gatv1_banded_attention(  # noqa: E731
            p, q, bias, v, 0.2, w, bias_storage=storage)
    _assert_close(*_both(jf, tf, x, cot))


SCAN_CASES = [
    # (gatv2, n, bandwidth, block_size, bias_storage): ragged last blocks,
    # a band wider than a block, a band wider than the sequence
    (True, 21, 3, 8, "band"), (True, 21, 10, 8, "full"), (True, 13, 20, 8, "band"),
    (False, 21, 5, 8, "band"), (False, 19, 9, 16, "full"), (True, 17, 6, 0, None),
]


@pytest.mark.parametrize("gatv2,n,w,bs,storage", SCAN_CASES)
def test_block_scan_matches_jax(gatv2, n, w, bs, storage):
    bias_shape = None if storage is None else ((n, 2 * w + 1) if storage == "band" else (n, n))
    x, cot = _inputs(2, 2, n, 4, 3, gatv2, bias_shape)
    storage = storage or "full"

    def jf(p, q, v, a=None, bias=None):
        return jops.banded_attention_scan(p, q, a, bias, v, 0.2, w, block_size=bs,
                                          bias_storage=storage)

    def tf(p, q, v, a=None, bias=None):
        return tops.banded_attention_scan(p, q, a, bias, v, 0.2, w, block_size=bs,
                                          bias_storage=storage)

    _assert_close(*_both(jf, tf, x, cot))


@pytest.mark.parametrize("gatv2", [True, False])
def test_coo_attention_matches_jax(gatv2):
    n = 7
    rng = np.random.default_rng(5)
    src, dst = tuple(rng.integers(0, n, 25).tolist()), tuple(rng.integers(0, n, 25).tolist())
    src, dst = src + tuple(range(n)), dst + tuple(range(n))   # every node a query
    jgraph, tgraph = jg.graph_from_edges(src, dst, n), tg.graph_from_edges(src, dst, n)
    x, cot = _inputs(3, 2, n, 4, 3, True, (n, n))
    if not gatv2:
        x["p"] = x["p"][..., :2]                     # wx of width 2; a = a_left || a_right
        del x["q"]

    if gatv2:
        def jf(p, q, a, v, bias):
            s = jops.gatv2_scores_coo(jgraph, p, q, a, 0.2)
            return jops.gat_aggregate_coo(jgraph, s, v, bias)

        def tf(p, q, a, v, bias):
            s = tops.gatv2_scores_coo(tgraph, p, q, a, 0.2)
            return tops.gat_aggregate_coo(tgraph, s, v, bias)
    else:
        def jf(p, a, v, bias):
            s = jops.gatv1_scores_coo(jgraph, p, a[:2], a[2:], 0.2)
            return jops.gat_aggregate_coo(jgraph, s, v, bias)

        def tf(p, a, v, bias):
            s = tops.gatv1_scores_coo(tgraph, p, a[:2], a[2:], 0.2)
            return tops.gat_aggregate_coo(tgraph, s, v, bias)

    _assert_close(*_both(jf, tf, x, cot))


def test_banded_paths_match_coo_on_the_band():
    """The port's three layouts of one banded function, against each other:
    unrolled, block scan (band-stored bias) and COO (its dense view)."""
    n, w = 23, 4
    x, cot = _inputs(4, 2, n, 4, 3, True, (n, 2 * w + 1))
    args = [_t(x[k]) for k in ("p", "q", "a")]
    bias, v = _t(x["bias"]), _t(x["v"])
    unrolled = tops.gatv2_banded_attention(*args, bias, v, 0.2, w, bias_storage="band")
    scan = tops.banded_attention_scan(*args, bias, v, 0.2, w, block_size=8, bias_storage="band")
    graph = tg.banded_graph(n, w)
    coo = tops.gat_aggregate_coo(graph, tops.gatv2_scores_coo(graph, *args, 0.2), v,
                                 tops.banded_bias_to_full(bias, n, w))
    torch.testing.assert_close(unrolled, coo, atol=TOL, rtol=0)
    torch.testing.assert_close(scan, coo, atol=TOL, rtol=0)


@pytest.mark.parametrize("n,w", [(9, 2), (6, 8)])
def test_bias_band_and_full_conversions_equal_jax(n, w):
    rng = np.random.default_rng(n)
    band = rng.standard_normal((n, 2 * w + 1)).astype(np.float32)
    full = rng.standard_normal((n, n)).astype(np.float32)
    np.testing.assert_array_equal(tops.banded_bias_to_full(_t(band), n, w).numpy(),
                                  np.asarray(jops.banded_bias_to_full(jnp.asarray(band), n, w)))
    for storage, bias in (("band", band), ("full", full)):
        np.testing.assert_array_equal(
            tops._banded_bias_cols(_t(bias), n, w, storage).numpy(),
            np.asarray(jops._banded_bias_cols(jnp.asarray(bias), n, w, storage)))
    # the band of the expanded matrix is the band, where it lies inside it
    back = tops._banded_bias_cols(tops.banded_bias_to_full(_t(band), n, w), n, w, "full")
    valid = tops._band_valid(n, w, "cpu")
    torch.testing.assert_close(back[valid], _t(band)[valid], atol=0, rtol=0)


@pytest.mark.parametrize("gatv2", [True, False])
def test_block_scan_recompute_keeps_the_dropout_mask(gatv2):
    """Gradients with each step recomputed in the backward pass equal those
    of the run that keeps every step's intermediates, at dropout 0.3; and
    the output is a dropped-out one (it differs from dropout 0)."""
    n, w = 26, 9
    x, cot = _inputs(6, 3, n, 4, 5, gatv2, (n, 2 * w + 1))
    seed = torch.tensor([123456789], dtype=torch.int64)

    def run(recompute, rate=0.3):
        leaves = {k: _t(val).requires_grad_() for k, val in x.items()}
        out = tops.banded_attention_scan(
            leaves["p"], leaves["q"], leaves.get("a"), leaves["bias"], leaves["v"], 0.2, w,
            block_size=8, dropout_rate=rate, dropout_seed=seed, bias_storage="band",
            recompute=recompute)
        grads = torch.autograd.grad((out * _t(cot)).sum(), list(leaves.values()))
        return out.detach(), grads

    out_r, grads_r = run(True)
    out_k, grads_k = run(False)
    torch.testing.assert_close(out_r, out_k, atol=0, rtol=0)
    for gr, gk in zip(grads_r, grads_k):
        torch.testing.assert_close(gr, gk, atol=0, rtol=0)
    assert (out_r - run(True, 0.0)[0]).abs().max() > 1e-3
