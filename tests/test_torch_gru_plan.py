"""The port's GRU kernels' dispatch by width and their split of the hidden
units over a thread-block cluster, on the CPU.

- ``gru_plan``: which variant of K3 (forward) and of K4's scan (backward)
  runs at a hidden width, and in clusters of how many blocks: at the
  flagship width 150, at a width the cluster divides, at width 1, and at the
  last width each choice holds and the first it does not.
- ``unit_slices`` cover the hidden units exactly once, ragged or even, and
  ``cluster_tiling`` keeps the invariants the CUDA sources rely on.
- The arithmetic of the cluster kernels, slice by slice in plain torch from
  those slices (each block's columns of W_hh laid out as the kernels lay
  them out, the step product as ``split`` partial sums added in order, the
  gate update for the block's own units, then the gathered state; for the
  backward each block's carry from the gathered gate gradients), against
  ``gru_step`` and against ``gru_scan_bwd_plain`` within 1e-6 in float32,
  and over a few steps against the JAX package's ``gru_scan_fused`` (the
  Pallas kernel in interpret mode) within 1e-5.

Inputs are drawn with numpy from a seed. The CUDA kernels themselves run on
the card only, where ``chip_smoke.py`` holds them against the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtad_gat_tpu.kernels.gru_pallas import gru_scan_fused
from mtad_gat_tpu_torch.kernels import gru as tgru

torch.set_num_threads(1)


@pytest.mark.parametrize("kernel,hid_dim,want", [
    ("fwd", 150, ("cluster", 4)), ("fwd", 64, ("cluster", 4)), ("fwd", 1, ("cluster", 4)),
    ("fwd", 168, ("cluster", 4)), ("fwd", 169, ("cluster", 8)),
    ("fwd", 311, ("cluster", 8)), ("fwd", 312, ("streaming", 0)),
    ("fwd", 512, ("streaming", 0)), ("fwd", 1816, ("streaming", 0)),
    ("bwd", 150, ("cluster", 5)), ("bwd", 64, ("cluster", 5)), ("bwd", 1, ("cluster", 5)),
    ("bwd", 160, ("cluster", 5)), ("bwd", 161, ("cluster", 8)),
    ("bwd", 192, ("cluster", 8)), ("bwd", 193, ("streaming", 0)),
    ("bwd", 384, ("streaming", 0)), ("bwd", 605, ("streaming", 0)),
])
def test_plan_by_width(kernel, hid_dim, want):
    variant, cluster = tgru.gru_plan(kernel, hid_dim)
    assert (variant, cluster) == want
    assert tgru.gru_smem_bytes(kernel, hid_dim, cluster) <= 227 * 1024
    if variant == "cluster":
        rows = tgru.K3_BATCH_TILE if kernel == "fwd" else tgru.K4_BATCH_TILE
        units = max(n for _, n in tgru.unit_slices(hid_dim, cluster))
        assert rows * units <= tgru.CLUSTER_THREADS      # a thread per (row, own unit)


@pytest.mark.parametrize("kernel,hid_dim", [("fwd", 1817), ("bwd", 606), ("fwd", 0)])
def test_plan_refuses_what_no_variant_holds(kernel, hid_dim):
    with pytest.raises(ValueError):
        tgru.gru_plan(kernel, hid_dim)


def test_plan_follows_the_cards_limits():
    # less shared memory: the slices stop fitting earlier
    assert tgru.gru_plan("fwd", 150, smem_limit=128 * 1024) == ("cluster", 8)
    assert tgru.gru_plan("bwd", 150, smem_limit=64 * 1024) == ("streaming", 0)
    # no clusters: one block cannot own 150 units
    assert tgru.gru_plan("fwd", 150, max_cluster=1) == ("streaming", 0)
    assert tgru.gru_plan("fwd", 32, max_cluster=1) == ("cluster", 1)
    with pytest.raises(ValueError):
        tgru.gru_plan("scan", 150)


@pytest.mark.parametrize("hid_dim,cluster", [
    (150, 4), (150, 5), (150, 8), (64, 4), (128, 8), (176, 8), (1, 4), (7, 8)])
def test_unit_slices_cover_every_unit_once(hid_dim, cluster):
    slices = tgru.unit_slices(hid_dim, cluster)
    assert len(slices) == cluster
    covered = np.concatenate([np.arange(s, s + n) for s, n in slices])
    np.testing.assert_array_equal(covered, np.arange(hid_dim))
    counts = [n for _, n in slices]
    assert max(counts) - min(counts) <= 1 and counts == sorted(counts, reverse=True)
    assert max(counts) == tgru.cluster_tiling(hid_dim, cluster, 8)[0]


@pytest.mark.parametrize("hid_dim,cluster,max_split", [
    (150, 4, 8), (150, 5, 4), (64, 4, 8), (200, 8, 8), (176, 8, 4), (1, 4, 8), (311, 8, 8)])
def test_tiling_invariants(hid_dim, cluster, max_split):
    units, gate_cols, stride, groups_pad, split = tgru.cluster_tiling(
        hid_dim, cluster, max_split)
    assert gate_cols % 4 == 0 and units <= gate_cols < units + 4
    assert stride >= 3 * gate_cols and stride % 4 == 0 and stride // 4 % 2 == 1
    assert groups_pad % 32 == 0 and groups_pad >= stride // 4
    assert 1 <= split <= min(max_split, hid_dim)
    assert split * groups_pad <= tgru.CLUSTER_THREADS


# ---------------------------------------------------------------------------
# The cluster kernels' arithmetic, slice by slice
# ---------------------------------------------------------------------------


def _slice_matrix(w, start, count, gate_cols, stride):
    """A block's slice of a (rows, 3H) matrix as the kernels store it:
    [row][gate * gate_cols + unit], zeros in the padding."""
    H = w.shape[1] // 3
    out = torch.zeros((w.shape[0], stride), dtype=w.dtype)
    for g in range(3):
        out[:, g * gate_cols:g * gate_cols + count] = w[:, g * H + start:g * H + start + count]
    return out


def _product(x, w_slice, split):
    """x (B, H) times a slice (H, stride) as ``split`` partial sums over the
    rows e = s, s + split, ..., added in order."""
    parts = [x[:, s::split] @ w_slice[s::split] for s in range(split)]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _inputs(seed, B, H, T=1):
    rng = np.random.default_rng(seed)
    gi = torch.from_numpy(rng.standard_normal((B, T, 3 * H)).astype(np.float32))
    w_hh = torch.from_numpy((0.2 * rng.standard_normal((H, 3 * H))).astype(np.float32))
    b_hh = torch.from_numpy((0.1 * rng.standard_normal(3 * H)).astype(np.float32))
    h = torch.from_numpy(np.tanh(rng.standard_normal((B, H))).astype(np.float32))
    return gi, w_hh, b_hh, h


def _forward_step_by_slices(g, h, w_hh, b_hh, cluster, max_split):
    """One K3 step as the cluster computes it: every block from the whole h,
    its own columns and its own units; returns the gathered new state."""
    H = h.shape[1]
    _, gate_cols, stride, _, split = tgru.cluster_tiling(H, cluster, max_split)
    h_new = torch.full_like(h, float("nan"))
    for start, count in tgru.unit_slices(H, cluster):
        gh = _product(h, _slice_matrix(w_hh, start, count, gate_cols, stride), split)
        gh = gh + _slice_matrix(b_hh[None], start, count, gate_cols, stride)
        own = slice(start, start + count)
        col = [slice(k * gate_cols, k * gate_cols + count) for k in range(3)]
        r = torch.sigmoid(g[:, own] + gh[:, col[0]])
        z = torch.sigmoid(g[:, H + start:H + start + count] + gh[:, col[1]])
        n = torch.tanh(g[:, 2 * H + start:2 * H + start + count] + r * gh[:, col[2]])
        h_new[:, own] = (1.0 - z) * n + z * h[:, own]
    return h_new


@pytest.mark.parametrize("hid_dim,cluster", [(150, 4), (150, 8), (64, 4), (5, 8), (200, 8)])
def test_forward_step_by_slices_equals_gru_step(hid_dim, cluster):
    gi, w_hh, b_hh, h = _inputs(hid_dim + cluster, 12, hid_dim)
    got = _forward_step_by_slices(gi[:, 0], h, w_hh, b_hh, cluster, tgru.K3_SPLIT)
    want = tgru.gru_step(gi[:, 0], h, w_hh, b_hh)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hid_dim,cluster", [(150, 4), (64, 4)])
def test_forward_scan_by_slices_equals_jax_kernel(hid_dim, cluster):
    T = 5
    gi, w_hh, b_hh, _ = _inputs(3, 8, hid_dim, T)
    h = torch.zeros((8, hid_dim))
    steps = []
    for t in range(T):
        h = _forward_step_by_slices(gi[:, t], h, w_hh, b_hh, cluster, tgru.K3_SPLIT)
        steps.append(h)
    want, _ = gru_scan_fused(jnp.asarray(gi.numpy()), jnp.asarray(w_hh.numpy()),
                             jnp.asarray(b_hh.numpy()), hid_dim, interpret=True)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


def _backward_step_by_slices(g, h_prev, dh, w_hh, b_hh, cluster, max_split):
    """One K4 scan step as the cluster computes it: every block forms the
    gate gradients of its own units, the gradients are gathered, and every
    block sums its own units' carry from all of them. Returns (dgi (B, 3H),
    carry (B, H))."""
    H = h_prev.shape[1]
    _, gate_cols, stride, _, split = tgru.cluster_tiling(H, cluster, max_split)
    slices = tgru.unit_slices(H, cluster)
    dgi = torch.full((h_prev.shape[0], 3 * H), float("nan"))
    dg = torch.full_like(dgi, float("nan"))
    dhz = torch.full_like(h_prev, float("nan"))
    for start, count in slices:
        gh = _product(h_prev, _slice_matrix(w_hh, start, count, gate_cols, stride), split)
        gh = gh + _slice_matrix(b_hh[None], start, count, gate_cols, stride)
        own = slice(start, start + count)
        col = [slice(k * gate_cols, k * gate_cols + count) for k in range(3)]
        gate = [slice(k * H + start, k * H + start + count) for k in range(3)]
        r = torch.sigmoid(g[:, gate[0]] + gh[:, col[0]])
        z = torch.sigmoid(g[:, gate[1]] + gh[:, col[1]])
        n = torch.tanh(g[:, gate[2]] + r * gh[:, col[2]])
        dn_pre = dh[:, own] * (1.0 - z) * (1.0 - n * n)
        dz_pre = dh[:, own] * (h_prev[:, own] - n) * z * (1.0 - z)
        dr_pre = dn_pre * gh[:, col[2]] * r * (1.0 - r)
        dgi[:, gate[0]], dgi[:, gate[1]], dgi[:, gate[2]] = dr_pre, dz_pre, dn_pre
        dg[:, gate[0]], dg[:, gate[1]], dg[:, gate[2]] = dr_pre, dz_pre, dn_pre * r
        dhz[:, own] = dh[:, own] * z
    carry = torch.full_like(h_prev, float("nan"))
    w_t = w_hh.t().contiguous()                        # (3H, H), the wrapper's second copy
    for start, count in slices:
        # the block's slice of W_hh^T: [k][gate * gate_cols + e] = W_hh[e, gate H + k]
        wt = torch.zeros((H, stride))
        for k in range(3):
            wt[:, k * gate_cols:k * gate_cols + count] = w_t[k * H:(k + 1) * H,
                                                             start:start + count]
        total = torch.zeros((h_prev.shape[0], count))
        for k in range(3):                             # column (gate, e) sums over that gate
            part = _product(dg[:, k * H:(k + 1) * H], wt, split)
            total = total + part[:, k * gate_cols:k * gate_cols + count]
        carry[:, start:start + count] = dhz[:, start:start + count] + total
    return dgi, carry


@pytest.mark.parametrize("hid_dim,cluster", [(150, 5), (150, 8), (64, 4), (5, 8), (176, 8)])
def test_backward_steps_by_slices_equal_plain(hid_dim, cluster):
    B, T = 12, 2
    gi, w_hh, b_hh, _ = _inputs(hid_dim * 7 + cluster, B, hid_dim, T)
    rng = np.random.default_rng(1)
    dhseq = torch.from_numpy(rng.standard_normal((B, T, hid_dim)).astype(np.float32))
    hseq, _ = tgru.gru_scan_fwd_plain(gi, w_hh, b_hh, hid_dim)
    want, _, _ = tgru.gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, hid_dim)
    dgi1, carry = _backward_step_by_slices(gi[:, 1], hseq[:, 0], dhseq[:, 1], w_hh, b_hh,
                                           cluster, tgru.K4_SPLIT)
    dgi0, _ = _backward_step_by_slices(gi[:, 0], torch.zeros((B, hid_dim)),
                                       carry + dhseq[:, 0], w_hh, b_hh, cluster,
                                       tgru.K4_SPLIT)
    assert torch.isfinite(dgi1).all() and torch.isfinite(dgi0).all()
    np.testing.assert_allclose(dgi1.numpy(), want[:, 1].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dgi0.numpy(), want[:, 0].numpy(), rtol=0, atol=1e-6)
