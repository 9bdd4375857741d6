"""The kernel modules' plain versions against the JAX package's kernels, on
the CPU.

- K1: ``gatv2_attention_fwd`` (plain, as a CPU tensor takes it) against
  ``gatv2_attention_fused(..., interpret=True)`` and ``_dense_reference``.
  Tolerance atol 2e-5, as ``tests/test_pallas_kernel.py`` holds the Pallas
  kernel to the dense path: float32 softmax-weighted sums of O(1) values
  summed in another order.
- K3: ``gru_scan_fwd`` (plain) against ``gru_scan_fused(interpret=True)`` and
  against ``torch.nn.GRU`` fed the same input projection. Tolerance atol
  2e-5: float32 products of width 150 summed in another order, carried
  through up to 100 contracting steps.

The CUDA kernels themselves run on the card only, where ``chip_smoke.py``
holds them against the same plain versions at the scoring shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.kernels.gat_pallas import _dense_reference, gatv2_attention_fused
from mtad_gat_tpu.kernels.gru_pallas import gru_scan_fused
from mtad_gat_tpu_torch.kernels.gat import gatv2_attention_fwd, gatv2_attention_fwd_plain
from mtad_gat_tpu_torch.kernels.gru import gru_scan_fwd, gru_scan_fwd_plain

torch.set_num_threads(1)

ATOL = 2e-5


def _gat_case(seed, b, n, e, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, n, e), f(b, n, e), f(e), (0.1 * f(n, n)).astype(np.float32), f(b, n, d)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,e,d", [(16, 32, 16), (38, 200, 100), (130, 40, 20)])
def test_gat_plain_matches_jax_kernel(n, e, d, with_bias):
    p, q, a, bias, v = _gat_case(0, 2, n, e, d)
    bias = bias if with_bias else None
    jargs = [jnp.asarray(x) if x is not None else None for x in (p, q, a, bias, v)]
    want_kernel = np.asarray(gatv2_attention_fused(*jargs, 0.2, interpret=True))
    want_dense = np.asarray(_dense_reference(*jargs, 0.2))
    targs = [torch.from_numpy(x) if x is not None else None for x in (p, q, a, bias, v)]
    before = gatv2_attention_fwd.launches
    got = gatv2_attention_fwd(*targs, 0.2).numpy()
    assert gatv2_attention_fwd.launches == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)
    np.testing.assert_allclose(got, want_dense, atol=ATOL)


def test_gat_plain_bf16_output_type_and_batch_chunking(monkeypatch):
    """bf16 inputs give a bf16 output from float32 math; the batch chunking
    that bounds the plain version's memory changes nothing."""
    import mtad_gat_tpu_torch.kernels.gat as gat_mod

    p, q, a, bias, v = (torch.from_numpy(x) for x in _gat_case(1, 5, 9, 12, 6))
    whole = gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2)
    monkeypatch.setattr(gat_mod, "_PLAIN_CHUNK_ELEMS", 9 * 9 * 12 * 2)
    chunked = gatv2_attention_fwd_plain(p, q, a, bias, v, 0.2)
    # the CPU matmul may pick another blocking for another batch: 1 ulp
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)
    bf = [t.to(torch.bfloat16) for t in (p, q, a, v)]
    out = gatv2_attention_fwd_plain(bf[0], bf[1], bf[2], bias, bf[3], 0.2)
    assert out.dtype == torch.bfloat16
    ref = gatv2_attention_fwd_plain(*(t.float() for t in bf[:3]), bias, bf[3].float(), 0.2)
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=4e-3)  # one bf16 rounding


def _gru_case(seed, B, T, H):
    rng = np.random.default_rng(seed)
    gi = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    w_hh = (0.2 * rng.standard_normal((H, 3 * H))).astype(np.float32)
    b_hh = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    return gi, w_hh, b_hh


@pytest.mark.parametrize("B,T,H", [(5, 13, 150), (8, 100, 150), (3, 7, 32)])
def test_gru_plain_matches_jax_kernel(B, T, H):
    gi, w_hh, b_hh = _gru_case(0, B, T, H)
    want_seq, want_last = gru_scan_fused(
        jnp.asarray(gi), jnp.asarray(w_hh), jnp.asarray(b_hh), H, interpret=True
    )
    before = gru_scan_fwd.launches
    got_seq, got_last = gru_scan_fwd(
        torch.from_numpy(gi), torch.from_numpy(w_hh), torch.from_numpy(b_hh), H
    )
    assert gru_scan_fwd.launches == before
    assert got_seq.dtype == torch.float32 and got_seq.shape == (B, T, H)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), atol=ATOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=ATOL)


@pytest.mark.parametrize("B,T,H", [(4, 20, 150), (3, 7, 32)])
def test_gru_plain_matches_torch_gru(B, T, H):
    """torch.nn.GRU computes the input projection itself from x; the plain
    version is fed gi = x W_ih^T + b_ih from the same weights."""
    rng = np.random.default_rng(1)
    gru = torch.nn.GRU(H, H, batch_first=True)
    with torch.no_grad():
        for prm in gru.parameters():
            prm.copy_(torch.from_numpy(
                (0.2 * rng.standard_normal(tuple(prm.shape))).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    with torch.no_grad():
        want_seq, want_last = gru(x)
        gi = x @ gru.weight_ih_l0.t() + gru.bias_ih_l0
        got_seq, got_last = gru_scan_fwd_plain(
            gi, gru.weight_hh_l0.t(), gru.bias_hh_l0, H)
    np.testing.assert_allclose(got_seq.numpy(), want_seq.numpy(), atol=ATOL)
    np.testing.assert_allclose(got_last.numpy(), want_last[0].numpy(), atol=ATOL)
