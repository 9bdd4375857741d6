"""The training attention of the port against the JAX package, on the CPU.

- The dropout hash: ``hash_keep_mask`` (``graph/dropout.py``, as
  ``kernels/gat`` uses it) equals ``gat_pallas.hash_keep_mask`` bit for
  bit, seeds across the whole uint32 range (2**31 + 5 and 2**32 - 1
  exercise the high bit), rates down to 1e-12 (the threshold clamp); a
  batch or row offset draws the matching slice.
- K1-res: ``gatv2_attention_res`` (its plain version, as a CPU tensor takes
  it) against ``_fused_forward(with_residuals=True, interpret=True)``; out
  and u to atol 2e-5, m to atol 1e-5 and l to rtol 1e-5, the K1 tolerances
  of ``tests/test_torch_kernels.py``, since m and l sum the same terms.
- K2a-c: the gradients of ``gatv2_attention`` against ``jax.grad`` through
  the Pallas backward (``_fused``, interpret mode) and against ``jax.vjp``
  of ``_dense_reference`` with the same hash mask; atol 5e-5, as
  ``tests/test_pallas_backward.py`` holds the Pallas backward to the dense
  one.

Inputs are drawn with numpy from a seed, as the JAX tests draw them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.kernels import gat_pallas
from mtad_gat_tpu_torch.graph import dropout as gdrop
from mtad_gat_tpu_torch.graph.ops import gat_aggregate_dense, gatv2_scores_dense
from mtad_gat_tpu_torch.kernels import gat as tgat

torch.set_num_threads(1)

SHAPES = [(20, 24, 12), (38, 200, 100), (130, 40, 20)]
SEED = 2**31 + 5


def _case(seed, b, n, e, d, with_bias):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((b, n, e)).astype(np.float32)
    q = rng.standard_normal((b, n, e)).astype(np.float32)
    a = rng.standard_normal(e).astype(np.float32)
    bias = (0.1 * rng.standard_normal((n, n))).astype(np.float32) if with_bias else None
    v = rng.standard_normal((b, n, d)).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    return (p, q, a, bias, v), g


def _j(xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _t(xs, grad=False):
    return [None if x is None else torch.from_numpy(x).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("rate", [0.3, 0.1, 1e-12])
def test_hash_keep_mask_is_bit_exact(seed, rate):
    want = np.asarray(gat_pallas.hash_keep_mask(jnp.uint32(seed), 3, 37, 41, rate))
    got = tgat.hash_keep_mask(seed, 3, 37, 41, rate).numpy()
    np.testing.assert_array_equal(got, want)
    # a seed given as a one-element int64 tensor, the layers' form, and a
    # batch offset (the plain versions' batch chunks) draw the same mask
    tail = tgat.hash_keep_mask(torch.tensor([seed]), 2, 37, 41, rate, batch_offset=1)
    np.testing.assert_array_equal(tail.numpy(), want[1:])
    # and a row offset (a chunk of query rows)
    rows = gdrop.hash_keep_mask(seed, 3, 20, 41, rate, row_offset=17)
    np.testing.assert_array_equal(rows.numpy(), want[:, 17:])


def test_hash_products_keep_their_low_32_bits():
    """Every uint32 product of the hash, for factors near 2**32 where an
    int64 product would pass 2**63, equals Python's exact arithmetic."""
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 2, 2**32 - 1])
    for c in (gdrop.DROP_C1, gdrop.DROP_C2, gdrop.DROP_C3, gdrop.DROP_CB):
        want = [(int(v) * c) % 2**32 for v in x]
        assert gdrop.mul32(x, c).tolist() == want
    assert gdrop.keep_threshold(1e-12) == 2**32 - 1
    assert gdrop.keep_threshold(0.0) == 2**32 - 1
    assert gdrop.keep_threshold(0.5) == 2**31


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,e,d", SHAPES)
def test_k1_res_plain_matches_jax_kernel(n, e, d, with_bias, rate):
    xs, _ = _case(0, 2, n, e, d, with_bias)
    want = gat_pallas._fused_forward(*_j(xs), 0.2, True, with_residuals=True,
                                     seed=jnp.uint32(SEED), dropout_rate=rate)
    before = tgat.gatv2_attention_res.launches
    out, u, m, l = tgat.gatv2_attention_res(*_t(xs), 0.2, SEED, rate)
    assert tgat.gatv2_attention_res.launches == before  # CPU tensors launch nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), atol=2e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(want[1]), atol=2e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(want[2]), atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(want[3]), rtol=1e-5)
    if not rate:
        # without dropout the output is the dense aggregate of graph/ops.py
        p, q, a, bias, v = _t(xs)
        dense = gat_aggregate_dense(gatv2_scores_dense(p, q, a, 0.2), v, bias)
        np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=2e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,e,d", SHAPES)
def test_gradients_match_jax_pallas_and_dense(n, e, d, with_bias, rate):
    xs, g = _case(1, 2, n, e, d, with_bias)
    argnums = (0, 1, 2, 3, 4) if with_bias else (0, 1, 2, 4)
    seed = jnp.full((1, 1), SEED, jnp.uint32)
    jx = _j(xs)

    def loss_fused(*args):
        full = list(jx)
        for i, x in zip(argnums, args):
            full[i] = x
        return jnp.sum(gat_pallas._fused(*full, seed, 0.2, True, rate) * g)

    keep = gat_pallas.hash_keep_mask(jnp.uint32(SEED), 2, n, n, rate) if rate else None

    def dense(*args):
        full = list(jx)
        for i, x in zip(argnums, args):
            full[i] = x
        return gat_pallas._dense_reference(*full, 0.2, keep=keep, dropout_rate=rate)

    want_fused = jax.grad(loss_fused, argnums=tuple(range(len(argnums))))(
        *[jx[i] for i in argnums])
    _, vjp = jax.vjp(dense, *[jx[i] for i in argnums])
    want_dense = vjp(jnp.asarray(g))

    leaves = _t(xs, grad=True)
    out = tgat.gatv2_attention(*leaves, 0.2, SEED, rate)
    (out * torch.from_numpy(g)).sum().backward()
    names = ["dp", "dq", "da", "dbias", "dv"]
    for k, i in enumerate(argnums):
        got = leaves[i].grad.numpy()
        np.testing.assert_allclose(got, np.asarray(want_fused[k]), atol=5e-5,
                                   err_msg=f"{names[i]} vs Pallas")
        np.testing.assert_allclose(got, np.asarray(want_dense[k]), atol=5e-5,
                                   err_msg=f"{names[i]} vs dense")


def test_gradients_match_closed_form():
    """The plain backward (autograd) against the closed forms of
    gat_pallas.py:406-413, written out with the hash mask."""
    xs, g = _case(2, 2, 9, 6, 5, True)
    p, q, a, bias, v = _t(xs)
    rate, alpha = 0.3, 0.2
    _, u, m, l = tgat.gatv2_attention_res(p, q, a, bias, v, alpha, SEED, rate)
    out = torch.sigmoid(u)
    du = torch.from_numpy(g) * out * (1 - out)
    dvec = (du * u).sum(-1)
    dp, dq, da, dbias, dv = tgat.gatv2_attention_bwd_plain(p, q, a, bias, v, du, alpha,
                                                           SEED, rate)
    z = p[:, :, None, :] + q[:, None, :, :]
    s = torch.nn.functional.leaky_relu(z, alpha) @ a + bias
    w = torch.exp(s - m[..., None]) / l[..., None]
    keep = tgat.hash_keep_mask(SEED, 2, 9, 9, rate)
    wa = torch.where(keep, w / (1 - rate), 0.0)
    ds = wa * (du @ v.transpose(1, 2)) - w * dvec[..., None]
    lrp = torch.where(z >= 0, 1.0, alpha)
    for got, want in (
        (dp, torch.einsum("bij,bije->bie", ds, lrp) * a),
        (dq, torch.einsum("bij,bije->bje", ds, lrp) * a),
        (da, torch.einsum("bij,bije->e", ds, torch.nn.functional.leaky_relu(z, alpha))),
        (dbias, ds.sum(0)),
        (dv, torch.einsum("bij,bid->bjd", wa, du)),
    ):
        torch.testing.assert_close(got, want, rtol=0, atol=5e-6)


def test_leaky_relu_ties_take_slope_one():
    """Where p_ie + q_je is exactly 0 the kernels, like jax.nn.leaky_relu,
    take the slope 1 (F.leaky_relu's gradient takes alpha): the plain
    backward agrees with the dense JAX reference on such ties."""
    xs, g = _case(4, 2, 10, 8, 6, True)
    p, q = xs[0], xs[1].copy()
    q[:, :5, :] = -p[:, :5, :]              # z = 0 on the pairs (i, i), i < 5
    xs = (p, q) + xs[2:]
    _, vjp = jax.vjp(lambda *a: gat_pallas._dense_reference(*a, 0.2), *_j(xs))
    want = vjp(jnp.asarray(g))
    leaves = _t(xs, grad=True)
    (tgat.gatv2_attention(*leaves, 0.2) * torch.from_numpy(g)).sum().backward()
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=5e-5)


def test_no_grad_call_takes_the_forward_alone():
    """Without a gradient and without dropout the call is K1's; with a
    gradient asked for, ``gatv2_attention`` records autograd history and
    K1's own wrapper, which has no backward, raises."""
    xs, _ = _case(3, 2, 7, 4, 3, True)
    plain = tgat.gatv2_attention_fwd_plain(*_t(xs), 0.2)
    with torch.no_grad():
        got = tgat.gatv2_attention(*_t(xs, grad=True), 0.2, SEED, 0.0)
    assert got.grad_fn is None
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    leaves = _t(xs, grad=True)
    out = tgat.gatv2_attention(*leaves, 0.2)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None for t in leaves if t is not None)
    with pytest.raises(RuntimeError, match="call gatv2_attention"):
        tgat.gatv2_attention_fwd(*leaves, 0.2)


def test_backward_kernels_take_cuda_tensors_only():
    """The CPU's backward is one plain call inside the autograd Function;
    the K2 wrappers (K2ab and its dispatcher too) launch kernels and refuse
    a CPU tensor."""
    xs, g = _case(5, 2, 7, 4, 3, True)
    p, q, a, bias, v = _t(xs)
    _, u, m, l = tgat.gatv2_attention_res(p, q, a, bias, v, 0.2)
    du = torch.from_numpy(g)
    dvec = (du * u).sum(-1)
    for fn in (tgat.gatv2_bwd_dp_da, tgat.gatv2_bwd_dq_dv, tgat.gatv2_bwd_dbias,
               tgat.gatv2_bwd_graph, tgat.gatv2_bwd):
        with pytest.raises(ValueError, match="unsupported device cpu"):
            fn(p, q, a, bias, v, m, l, du, dvec, 0.2)


def test_dbias_chunks_fill_the_card():
    """K2c's batch chunks give about two blocks per multiprocessor of the
    card at hand, each chunk non-empty."""
    assert tgat.dbias_chunks(256, 38, 132) == 43    # 6 tiles: 258 blocks
    assert tgat.dbias_chunks(256, 38, 114) == 37    # a 114-SM part: 222 blocks
    assert tgat.dbias_chunks(256, 2048, 132) == 1   # 8,192 tiles fill it alone
    assert tgat.dbias_chunks(3, 38, 132) == 3       # never an empty chunk


def test_dense_dropout_needs_a_generator():
    xs, _ = _case(6, 2, 7, 4, 3, True)
    p, q, a, bias, v = _t(xs)
    s = gatv2_scores_dense(p, q, a, 0.2)
    with pytest.raises(ValueError, match="needs a generator"):
        gat_aggregate_dense(s, v, bias, 0.3)
    gen = torch.Generator().manual_seed(0)
    dropped = gat_aggregate_dense(s, v, bias, 0.3, gen)
    assert not torch.allclose(dropped, gat_aggregate_dense(s, v, bias))
