"""The port's GRU backward through time (K4) against the JAX package, on the
CPU.

- ``gru_scan_bwd_plain`` (the kernel's function step by step) and autograd
  through ``gru_scan`` (which takes the plain forward and backward on a CPU
  tensor) against ``jax.grad`` of ``gru_scan_fused(interpret=True)``, that
  is through the Pallas BPTT kernel: dgi, dW_hh and db_hh at the shapes of
  ``tests/test_gru_pallas.py``, with a dense cotangent and with one on
  ``h_last`` only. Tolerance rtol 1e-5 and atol 1e-5 times the gradient's
  largest value: the same float32 terms summed in another order, with dW_hh
  and db_hh sums over B * T rows.
- At T = 1024 (small B and H) against ``jax.grad`` of a ``lax.scan`` GRU,
  the oracle of ``tests/test_gru_pallas.py``; same tolerance.
- bfloat16 ``gi`` (float32 arithmetic, dgi returned in bfloat16), a batch
  that fills no tile of 8 rows, double backward, the launcher's refusal of
  CPU tensors, and the launch counters, which a CPU tensor never moves.

Inputs are drawn with numpy from a seed, as the JAX tests draw them. The
CUDA kernel itself runs on the card only, where ``chip_smoke.py`` holds it
against ``gru_scan_bwd_plain``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.kernels.gru_pallas import gru_scan_fused
from mtad_gat_tpu_torch.kernels import gru as tgru

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_OF_MAX = 1e-5
NAMES = ("dgi", "dw_hh", "db_hh")


def _case(seed, B, T, H):
    rng = np.random.default_rng(seed)
    gi = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    w_hh = (0.2 * rng.standard_normal((H, 3 * H))).astype(np.float32)
    b_hh = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    g = rng.standard_normal((B, T, H)).astype(np.float32)
    return gi, w_hh, b_hh, g


def _cotangent(g, dense):
    """The cotangent of hseq: dense, or zero except on h_last."""
    if dense:
        return g
    last = np.zeros_like(g)
    last[:, -1] = g[:, -1]
    return last


def _assert_grads_close(got, want):
    for name, a, b in zip(NAMES, got, want):
        a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_OF_MAX * np.abs(b).max(),
                                   err_msg=name)


def _jax_pallas_grads(gi, w_hh, b_hh, ct, H):
    def loss(gi, w, b):
        seq, _ = gru_scan_fused(gi, w, b, H, interpret=True)
        return jnp.sum(seq * ct)

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(gi), jnp.asarray(w_hh),
                                             jnp.asarray(b_hh))


def _jax_scan_grads(gi, w_hh, b_hh, ct, H):
    def loss(gi, w, b):
        def step(h, gi_t):
            gh = h @ w + b
            i_r, i_z, i_n = jnp.split(gi_t, 3, axis=-1)
            h_r, h_z, h_n = jnp.split(gh, 3, axis=-1)
            r = jax.nn.sigmoid(i_r + h_r)
            z = jax.nn.sigmoid(i_z + h_z)
            n = jnp.tanh(i_n + r * h_n)
            new = (1 - z) * n + z * h
            return new, new

        h0 = jnp.zeros((gi.shape[0], H), jnp.float32)
        _, outs = jax.lax.scan(step, h0, jnp.swapaxes(gi, 0, 1))
        return jnp.sum(jnp.swapaxes(outs, 0, 1) * ct)

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(gi), jnp.asarray(w_hh),
                                             jnp.asarray(b_hh))


def _autograd_through_gru_scan(gi, w_hh, b_hh, ct, H, on_h_last=False):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (gi, w_hh, b_hh)]
    before = (tgru.gru_scan_fwd.launches, tgru.gru_scan_bwd.launches)
    hseq, h_last = tgru.gru_scan(*leaves, H)
    if on_h_last:
        # as the encoder consumes it: autograd hands the Function a gradient
        # that is zero except at the last step
        (h_last * torch.from_numpy(ct[:, -1])).sum().backward()
    else:
        (hseq * torch.from_numpy(ct)).sum().backward()
    assert (tgru.gru_scan_fwd.launches, tgru.gru_scan_bwd.launches) == before
    return [t.grad for t in leaves]


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "h_last"])
@pytest.mark.parametrize("B,T,H", [(5, 13, 150), (4, 21, 64)])
def test_plain_backward_matches_jax_pallas_bptt(B, T, H, dense):
    gi, w_hh, b_hh, g = _case(1, B, T, H)
    ct = _cotangent(g, dense)
    want = _jax_pallas_grads(gi, w_hh, b_hh, ct, H)
    t = [torch.from_numpy(x) for x in (gi, w_hh, b_hh)]
    hseq, _ = tgru.gru_scan_fwd_plain(*t, H)
    got = tgru.gru_scan_bwd_plain(*t, hseq, torch.from_numpy(ct), H)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "h_last"])
@pytest.mark.parametrize("B,T,H", [(5, 13, 150), (4, 21, 64)])
def test_gru_scan_autograd_matches_jax_pallas_bptt(B, T, H, dense):
    gi, w_hh, b_hh, g = _case(2, B, T, H)
    want = _jax_pallas_grads(gi, w_hh, b_hh, _cotangent(g, dense), H)
    got = _autograd_through_gru_scan(gi, w_hh, b_hh, g, H, on_h_last=not dense)
    _assert_grads_close(got, want)


def test_long_window_matches_jax_scan():
    B, T, H = 2, 1024, 12
    gi, w_hh, b_hh, g = _case(3, B, T, H)
    want = _jax_scan_grads(gi, w_hh, b_hh, g, H)
    got = _autograd_through_gru_scan(gi, w_hh, b_hh, g, H)
    _assert_grads_close(got, want)


def test_plain_backward_equals_autograd_of_plain_forward():
    """The step-by-step backward against autograd of ``gru_scan_fwd_plain``,
    the other oracle the card check uses; a batch of 11 fills one tile of 8
    rows and leaves a ragged one."""
    B, T, H = 11, 9, 20
    gi, w_hh, b_hh, g = _case(4, B, T, H)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (gi, w_hh, b_hh)]
    hseq, _ = tgru.gru_scan_fwd_plain(*leaves, H)
    want = torch.autograd.grad((hseq * torch.from_numpy(g)).sum(), leaves)
    got = tgru.gru_scan_bwd_plain(*(t.detach() for t in leaves), hseq.detach(),
                                  torch.from_numpy(g), H)
    _assert_grads_close(got, [w.numpy() for w in want])
    _assert_grads_close(_autograd_through_gru_scan(gi, w_hh, b_hh, g, H),
                        [w.numpy() for w in want])


def test_bfloat16_gi_keeps_float32_arithmetic():
    """gi in bfloat16: every sum is float32, dgi comes back in bfloat16 (one
    rounding, 2**-8 relative), dW_hh and db_hh in the weights' float32."""
    B, T, H = 3, 10, 16
    gi, w_hh, b_hh, g = _case(5, B, T, H)
    gi_bf = torch.from_numpy(gi).to(torch.bfloat16)
    want = _jax_pallas_grads(gi_bf.float().numpy(), w_hh, b_hh, g, H)
    leaves = [gi_bf.requires_grad_(), torch.from_numpy(w_hh).requires_grad_(),
              torch.from_numpy(b_hh).requires_grad_()]
    hseq, _ = tgru.gru_scan(*leaves, H)
    assert hseq.dtype == torch.float32
    (hseq * torch.from_numpy(g)).sum().backward()
    dgi, dw, db = (t.grad for t in leaves)
    assert dgi.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    scale = np.abs(np.asarray(want[0])).max()
    np.testing.assert_allclose(dgi.float().numpy(), np.asarray(want[0]), rtol=2**-8,
                               atol=2**-8 * scale)
    _assert_grads_close((dw, db), want[1:])


def test_gradient_only_where_asked():
    """``needs_input_grad`` is honoured: frozen recurrent weights get no
    gradient, and a frozen input projection still trains them."""
    B, T, H = 2, 6, 8
    gi, w_hh, b_hh, g = _case(6, B, T, H)
    full = _autograd_through_gru_scan(gi, w_hh, b_hh, g, H)
    gi_t = torch.from_numpy(gi).requires_grad_()
    w_t, b_t = torch.from_numpy(w_hh), torch.from_numpy(b_hh)
    hseq, _ = tgru.gru_scan(gi_t, w_t, b_t, H)
    (hseq * torch.from_numpy(g)).sum().backward()
    assert w_t.grad is None and b_t.grad is None
    torch.testing.assert_close(gi_t.grad, full[0], rtol=0, atol=0)
    w_t.requires_grad_()
    hseq, _ = tgru.gru_scan(torch.from_numpy(gi), w_t, b_t, H)
    (hseq * torch.from_numpy(g)).sum().backward()
    torch.testing.assert_close(w_t.grad, full[1], rtol=0, atol=0)


def test_no_grad_call_is_the_forward_alone():
    gi, w_hh, b_hh, _ = _case(7, 2, 5, 4)
    t = [torch.from_numpy(x) for x in (gi, w_hh, b_hh)]
    want, _ = tgru.gru_scan_fwd_plain(*t, 4)
    with torch.no_grad():
        hseq, h_last = tgru.gru_scan(*(x.clone().requires_grad_() for x in t), 4)
    assert hseq.grad_fn is None
    torch.testing.assert_close(hseq, want, rtol=0, atol=0)
    torch.testing.assert_close(h_last, want[:, -1], rtol=0, atol=0)
    # K3's own launcher records no gradient and says where to go
    with pytest.raises(RuntimeError, match="call gru_scan"):
        tgru.gru_scan_fwd(t[0].requires_grad_(), t[1], t[2], 4)


def test_gru_scan_refuses_double_backward():
    gi, w_hh, b_hh, _ = _case(8, 2, 5, 4)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (gi, w_hh, b_hh)]
    hseq, _ = tgru.gru_scan(*leaves, 4)
    # the cotangent 2 hseq depends on the leaves, so a second derivative exists
    (dgi,) = torch.autograd.grad((hseq * hseq).sum(), leaves[:1], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dgi.sum().backward()


def test_backward_kernel_takes_cuda_tensors_only():
    gi, w_hh, b_hh, g = _case(9, 2, 5, 4)
    t = [torch.from_numpy(x) for x in (gi, w_hh, b_hh)]
    hseq, _ = tgru.gru_scan_fwd_plain(*t, 4)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        tgru.gru_scan_bwd(*t, hseq, torch.from_numpy(g), 4)
    assert tgru.gru_scan_bwd.launches == 0


def test_weight_grad_chunks_fill_the_card():
    """K4's dW_hh product splits its rows until the (H, 3H) output's few
    tiles give about two blocks per multiprocessor."""
    assert tgru.weight_grad_chunks(256 * 100, 150, 132) == 11   # 24 tiles: 264 blocks
    assert tgru.weight_grad_chunks(256 * 100, 150, 114) == 10
    assert tgru.weight_grad_chunks(20, 150, 132) == 2           # never below a 16-row stage
    assert tgru.weight_grad_chunks(256 * 100, 1024, 132) == 1   # 768 tiles fill it alone
