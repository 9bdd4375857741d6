"""GAT attention primitives: scores, softmax and aggregation, as plain
tensor ops.

The port of ``mtad_gat_tpu/graph/ops.py``, three layouts of one function:

- **dense** (``:34-86``): all pairs of a complete graph, the path behind
  ``attention_impl="dense"`` and the oracle of the fused kernel. GATv2
  scores are computed in decomposed form, ``e_ij = a . leakyrelu(p_i + q_j)``
  with ``p = v @ W_l`` and ``q = v @ W_r + b``, so the reference's (b,N,N,2d)
  concat tensor is never built; the (b,N,N,e) sum is built here (eager
  PyTorch does not fuse it away as XLA does), which is what
  ``nn/gat.dense_gatv2_bytes`` counts.
- **banded** (``:119-427``): a band |i - j| <= W in the (b, N, 2W+1)
  diagonal layout, unrolled over the 2W+1 offsets for small W, or as a scan
  over block-diagonal offsets with an online softmax whose steps are
  recomputed in the backward pass (``banded_attention_scan``), whose memory
  does not grow with W.
- **COO** (``:434-489``): any edge list, segment softmax over destinations.

Each reduces to the dense result on the edges it holds (the tests hold all
three against the JAX functions and each other).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mtad_gat_tpu_torch.graph.dropout import bernoulli_keep, hash_u32, keep_threshold
from mtad_gat_tpu_torch.graph.segment import segment_softmax, segment_sum
from mtad_gat_tpu_torch.graph.structure import Graph


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, alpha x)``, whose gradient
    at x = 0 is 1 (``F.leaky_relu``'s is alpha), as the fused kernels' is."""
    return torch.where(x >= 0, x, alpha * x)


def gatv2_scores_dense(
    p: torch.Tensor,   # (b, N, e) left projection (query side)
    q: torch.Tensor,   # (b, N, e) right projection + lin bias (key side)
    a: torch.Tensor,   # (e,)
    alpha: float,
) -> torch.Tensor:
    """All-pairs GATv2 scores: e_ij = a . leakyrelu(p_i + q_j).  (b, N, N)
    float32: the sum over e accumulates in float32 whatever the input type."""
    z = leaky_relu(p[:, :, None, :] + q[:, None, :, :], alpha)
    return torch.matmul(z.float(), a.float())


def gatv1_scores_dense(
    wx: torch.Tensor,       # (b, N, e) shared projection
    a_left: torch.Tensor,   # (e,)
    a_right: torch.Tensor,  # (e,)
    alpha: float,
) -> torch.Tensor:
    """GATv1 scores are rank-1: e_ij = leakyrelu(u_i + w_j) with
    u = Wx . a_left, w = Wx . a_right (reference ``modules.py:80-83``)."""
    u = torch.matmul(wx.float(), a_left.float())
    w = torch.matmul(wx.float(), a_right.float())
    return leaky_relu(u[:, :, None] + w[:, None, :], alpha)


def gat_aggregate_dense(
    scores: torch.Tensor,          # (b, N, N)
    values: torch.Tensor,          # (b, N, d)
    bias: Optional[torch.Tensor],  # (N, N) or None
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """softmax over keys -> (optional dropout) -> weighted sum -> sigmoid.

    Dropout (reference placement, ``modules.py:89-90``: the softmaxed
    weights are masked and scaled by 1/(1-p), not renormalised) draws a
    Bernoulli mask from ``generator``, which must be on the scores' device."""
    if bias is not None:
        scores = scores + bias
    att = _dropout(torch.softmax(scores.float(), dim=2), dropout_rate, generator)
    h = torch.matmul(att, values.float()).to(values.dtype)
    return torch.sigmoid(h)


def _dropout(att: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """The reference's attention dropout (``modules.py:90``): a Bernoulli
    keep mask from ``generator``, kept weights scaled by 1/(1-rate)."""
    if rate <= 0.0:
        return att
    keep = bernoulli_keep(att, torch.full_like(att, 1.0 - rate), generator)
    return torch.where(keep, att / (1.0 - rate), 0.0)


# ---------------------------------------------------------------------------
# Banded layout: scores as (b, N, 2W+1), one column per diagonal offset
# o = j - i, built from rolls of the key side (no gathers).
# ---------------------------------------------------------------------------

# At and below this bandwidth the layer takes the unrolled banded path
# (2W+1 rolls), above it the block scan. Kept at the JAX package's value
# from measurements on an NVIDIA H100 80GB HBM3 (bench_graph_torch.py
# --band, PERF.md "PR 8"): the unrolled path wins at W 8 (3-4x in training)
# and ties the scan at W 32 at lookback 1024 and 4096, and the scan wins
# from W 64; the unrolled path also keeps 2W+1 (b, N, e) copies for its
# backward (74 GB at lookback 4096, W 256, batch 64).
BAND_UNROLL_CUTOFF = 32


# The block scan's block size B when the caller gives none: 32 at every
# bandwidth. On an NVIDIA H100 80GB HBM3 (bench_graph_torch.py --band,
# PERF.md "PR 8") B 32 was the fastest of 32, 64, 128 and 256 at every W
# from 8 to 256, at lookback 1024 and 4096, in the forward and in training,
# and held the least memory: eager PyTorch builds each step's (b, M, B, B, e)
# intermediate, which grows with B, while the band's cover grows only with
# W + B. (The JAX package's 128, or 64 from W 192, was set on a TPU, where
# the intermediate stays in fast memory.)
DEFAULT_BLOCK_SIZE = 32


def _banded_bias_cols(bias: torch.Tensor, n: int, bandwidth: int,
                      bias_storage: str) -> torch.Tensor:
    """(N, 2W+1) diagonal view of the score bias: the (N, N) matrix's band
    for ``bias_storage="full"``; the parameter itself for ``"band"``, whose
    column w holds offset w - W."""
    if bias_storage == "band":
        return bias
    i = torch.arange(n, device=bias.device)[:, None]
    j = i + torch.arange(-bandwidth, bandwidth + 1, device=bias.device)[None, :]
    return bias[i, j.clamp(0, n - 1)]


def banded_bias_to_full(bias_band: torch.Tensor, n: int, bandwidth: int) -> torch.Tensor:
    """Expand (N, 2W+1) banded bias storage to the dense (N, N) matrix,
    zero off the band (the COO path's view; O(N^2), small N)."""
    dev = bias_band.device
    i = torch.arange(n, device=dev)[:, None].expand(n, 2 * bandwidth + 1)
    j = i + torch.arange(-bandwidth, bandwidth + 1, device=dev)[None, :]
    valid = (j >= 0) & (j < n)
    full = bias_band.new_zeros((n, n))
    return full.index_put((i[valid], j[valid]), bias_band[valid], accumulate=True)


def _band_valid(n: int, bandwidth: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device)[:, None]
    o = torch.arange(-bandwidth, bandwidth + 1, device=device)[None, :]
    return ((i + o) >= 0) & ((i + o) < n)                    # (N, 2W+1)


def _banded_finish(
    scores: torch.Tensor,           # (b, N, 2W+1) raw diagonal-layout scores
    bias: Optional[torch.Tensor],
    v: torch.Tensor,                # (b, N, d)
    bandwidth: int,
    bias_storage: str,
    dropout_rate: float,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Shared tail of the unrolled banded paths: mask the rolls' wraps, add
    the bias, softmax over the band, dropout, aggregate, sigmoid."""
    n = v.shape[1]
    if bias is not None:
        scores = scores + _banded_bias_cols(bias, n, bandwidth, bias_storage)[None].float()
    scores = torch.where(_band_valid(n, bandwidth, v.device)[None], scores, float("-inf"))
    att = _dropout(torch.softmax(scores, dim=-1), dropout_rate, generator)
    out = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for idx, off in enumerate(range(-bandwidth, bandwidth + 1)):
        # invalid offsets carry att == 0, so the wrapped rows add nothing
        out = out + att[:, :, idx:idx + 1] * torch.roll(v, -off, dims=1).float()
    return torch.sigmoid(out).to(v.dtype)


def gatv2_banded_attention(
    p: torch.Tensor,        # (b, N, e) query-side projection
    q: torch.Tensor,        # (b, N, e) key-side projection (+ lin bias)
    a: torch.Tensor,        # (e,)
    bias: Optional[torch.Tensor],   # (N, N) or (N, 2W+1) score bias, or None
    v: torch.Tensor,        # (b, N, d)
    alpha: float,
    bandwidth: int,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    bias_storage: str = "full",
) -> torch.Tensor:
    """Banded GATv2 attention (node i attends to |i - j| <= bandwidth),
    unrolled over the 2W+1 offsets: the small-W path."""
    af = a.float()
    cols = [torch.matmul(leaky_relu(p + torch.roll(q, -o, dims=1), alpha).float(), af)
            for o in range(-bandwidth, bandwidth + 1)]
    return _banded_finish(torch.stack(cols, dim=-1), bias, v, bandwidth, bias_storage,
                          dropout_rate, generator)


def gatv1_banded_attention(
    u: torch.Tensor,        # (b, N) query-side rank-1 score half (Wx . a_left)
    w: torch.Tensor,        # (b, N) key-side half (Wx . a_right)
    bias: Optional[torch.Tensor],
    v: torch.Tensor,        # (b, N, d)
    alpha: float,
    bandwidth: int,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    bias_storage: str = "full",
) -> torch.Tensor:
    """Banded GATv1 attention: its scores are rank-1 (``modules.py:80-83``),
    so each diagonal is a roll of the key half."""
    u, w = u.float(), w.float()
    cols = [leaky_relu(u + torch.roll(w, -o, dims=1), alpha)
            for o in range(-bandwidth, bandwidth + 1)]
    return _banded_finish(torch.stack(cols, dim=-1), bias, v, bandwidth, bias_storage,
                          dropout_rate, generator)


def _pad_nodes(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    cfg = [0, 0] * (x.dim() - 2) + [0, pad]            # F.pad runs last dim first
    return F.pad(x, cfg)


class _RecomputedStep(torch.autograd.Function):
    """One step of the block scan that keeps only its inputs and recomputes
    itself in the backward pass, as ``jax.checkpoint(step)`` does in the
    JAX scan (``mtad_gat_tpu/graph/ops.py:424``). ``torch.utils.checkpoint``
    does the same through saved-tensor hooks, which ``torch.func.grad``
    refuses; this Function's backward recomputes the step through
    ``torch.func.vjp`` and vmap rules for it (``generate_vmap_rule``), so
    one recompute serves a solo call and a fleet step
    (``vmap(grad_and_value)``) alike.

    Inputs: the step (a function of the rest), the offset d, the carry (the
    running max, which carries no gradient, the denominator and the
    weighted sum), pB, qB, vB, af, the bias (or its band blocks), the
    attendable keys in block layout (or None) and the seed: what
    ``checkpoint`` kept. The step draws from no generator, so a
    recompute is the forward's function bit for bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(step, d, m_run, denom, acc, pB, qB, vB, af, bias, kv, seed):
        return step(d, m_run, denom, acc, pB, qB, vB, af, bias, kv, seed)

    @staticmethod
    def setup_context(ctx, inputs, output):
        step, d, m_run, denom, acc, pB, qB, vB, af, bias, kv, seed = inputs
        ctx.mark_non_differentiable(output[0])
        ctx.step, ctx.d = step, d
        ctx.seed = None if isinstance(seed, torch.Tensor) else seed
        ctx.save_for_backward(m_run, denom, acc, pB, qB, vB, af, bias, kv,
                              seed if isinstance(seed, torch.Tensor) else None)

    @staticmethod
    def backward(ctx, _, g_denom, g_acc):
        m_run, *diff, kv, seed = ctx.saved_tensors
        seed = ctx.seed if seed is None else seed
        # the step's differentiable inputs: denom, acc, pB, qB, vB, af, bias
        live = [i for i, t in enumerate(diff) if t is not None and ctx.needs_input_grad[3 + i]]

        def recompute(*xs):
            args = list(diff)
            for i, x in zip(live, xs):
                args[i] = x
            return ctx.step(ctx.d, m_run, *args, kv, seed)[1:]

        # no_grad: torch.func.grad runs the backward pass with create_graph
        # on, so a recorded recompute would keep every step's (b, M, B, B, e)
        # intermediates until the transform returns (five steps' worth at
        # band 64); vjp differentiates at its own level all the same, and the
        # step's gradient is not differentiated again
        with torch.no_grad():
            _, vjp = torch.func.vjp(recompute, *(diff[i] for i in live))
            # retain_graph off: each recomputed intermediate is freed once its
            # node has run, as checkpoint's recompute frees it (kept, the
            # step's backward would hold one more score tensor at peak)
            grads = [None] * len(diff)
            for i, g in zip(live, vjp((g_denom, g_acc), retain_graph=False)):
                grads[i] = g
        return (None, None, None, *grads, None, None)


def banded_attention_scan(
    p: torch.Tensor,        # GATv2: (b, N, e) query proj; GATv1: (b, N) u half
    q: torch.Tensor,        # GATv2: (b, N, e) key proj;   GATv1: (b, N) w half
    a: Optional[torch.Tensor],      # GATv2: (e,); GATv1: None
    bias: Optional[torch.Tensor],   # (N, N) or (N, 2W+1), per bias_storage
    v: torch.Tensor,        # (b, N, d)
    alpha: float,
    bandwidth: int,
    block_size: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    bias_storage: str = "full",
    recompute: bool = True,
    key_valid: Optional[torch.Tensor] = None,   # (N,) bool: the keys that may be attended
    hash_offset: int = 0,
) -> torch.Tensor:
    """Banded attention whose memory does not grow with W: a loop over
    block-diagonal offsets with an online softmax (running max, denominator
    and weighted sum), ``mtad_gat_tpu/graph/ops.py:240-427``.

    The sequence is cut into M blocks of B nodes; step d scores each block
    m against block m+d as a dense (B, B) tile and folds it into the running
    softmax. With ``recompute`` each step runs as ``_RecomputedStep``: the
    backward pass recomputes the step's (b, M, B, B, e) score intermediate
    rather than keep one per step, under ``torch.func.vmap(grad(...))`` (a
    fleet step) as in a solo call.

    Dropout: ``dropout_seed`` (an int, or one int64 value on the device,
    drawn once per layer call) keys a hash of the global (batch, i, j), the
    kernels' function (``graph/dropout.py``). A recomputed step
    therefore draws the same mask, and each pair gets one draw whatever B
    is. Under vmap ``dropout_seed`` is an entity's own and the batch index
    is within the entity, so each entity's mask is its solo call's. The
    mask applies to the numerator only, as the reference's dropout on the
    normalised weights does. ``hash_offset`` is added to both node indices
    before they are hashed: a block of a longer sequence whose node 0 is
    that sequence's node ``hash_offset`` draws the whole sequence's mask
    for its pairs (``parallel/banded_halo.py``).

    ``key_valid`` marks the keys that may be attended at all (rows stay
    queries), as in the JAX function: the halo path's hook for halo rows
    that lie outside the sequence. It travels in block layout and rolls
    with the key blocks.
    """
    gatv2 = a is not None
    b, n, dv = v.shape
    dev = v.device
    if block_size <= 0:
        block_size = DEFAULT_BLOCK_SIZE
    B = min(block_size, -(-n // 8) * 8)          # never larger than padded N
    M = -(-n // B)
    pad = M * B - n
    if gatv2:
        pB = _pad_nodes(p, pad).reshape(b, M, B, -1)
        qB = _pad_nodes(q, pad).reshape(b, M, B, -1)
        af = a.float()
    else:
        pB = _pad_nodes(p.float(), pad).reshape(b, M, B)
        qB = _pad_nodes(q.float(), pad).reshape(b, M, B)
        af = None
    vB = _pad_nodes(v, pad).float().reshape(b, M, B, dv)
    kvB = None
    if key_valid is not None:
        kvB = torch.cat([key_valid.bool(), key_valid.new_zeros(pad, dtype=torch.bool)])
        kvB = kvB.reshape(M, B)
    D = min(-(-bandwidth // B), M)     # block offsets covering the band
    rate = dropout_rate
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("attention dropout in the block scan needs a dropout_seed")

    # The band-stored bias's (B, B) tile of step d is bb[m, i, j] =
    # band[m*B + i, d*B + j - i + W]; its column shift depends on i alone,
    # so it is cut out with one column slice and a flatten/stride reshape
    # (row i of a (B, C) window starts at flat offset i*(C-1) + B-1 of the
    # strided view), with no gather. The step takes these blocks as its
    # bias, so that their gradient flows through its recompute.
    C = 2 * B - 1
    if bias is not None and bias_storage == "band":
        bias = F.pad(bias.float(), (0, 0, 0, pad)).reshape(M, B, 2 * bandwidth + 1)
        bias = F.pad(bias, (2 * B, 2 * B))
    keep_below = keep_threshold(rate) if rate > 0.0 else 0

    def step(d: int, m_run, denom, acc, pB, qB, vB, af, bias, kv, seed):
        # the index tensors are made here, not captured: a tensor made
        # under a torch.func transform and read inside _RecomputedStep
        # would belong to a level the Function has left
        gi = (torch.arange(M, device=dev) * B)[:, None] + torch.arange(B, device=dev)[None, :]
        gi_c = gi.clamp(0, n - 1)
        li = torch.arange(B, device=dev)
        loff = li[None, :] - li[:, None]          # (B, B) = lj - li
        qd = torch.roll(qB, -d, dims=1)
        vd = torch.roll(vB, -d, dims=1)
        gj = gi + d * B                           # (M, B) global j
        valid = (((d * B + loff).abs()[None] <= bandwidth)
                 & (gj[:, None, :] >= 0) & (gj[:, None, :] < n)
                 & (gi[:, :, None] < n))           # (M, B, B)
        if kv is not None:
            valid = valid & torch.roll(kv, -d, dims=0)[:, None, :]
        if gatv2:
            z = leaky_relu(pB[:, :, :, None, :] + qd[:, :, None, :, :], alpha)
            s = torch.matmul(z.float(), af)       # (b, M, B, B)
        else:
            s = leaky_relu(pB[:, :, :, None] + qd[:, :, None, :], alpha)
        if bias is not None:
            if bias_storage == "band":
                c0 = d * B + bandwidth - (B - 1) + 2 * B
                flat = bias[:, :, c0:c0 + C].reshape(M, B * C)
                bb = flat[:, B - 1:B - 1 + B * (C - 1)].reshape(M, B, C - 1)[:, :, :B]
            else:
                bb = bias[gi_c[:, :, None], gj.clamp(0, n - 1)[:, None, :]].float()
            s = s + bb[None]
        # online softmax; the running max is a shift, so it carries no
        # gradient; rows with no valid key yet stay at -inf with denominator 0
        blk_max = torch.where(valid[None], s.detach(), float("-inf")).amax(dim=-1)
        m_new = torch.maximum(m_run, blk_max)
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        scale = torch.where(torch.isfinite(m_run), torch.exp(m_run - safe_m), 0.0)
        wgt = torch.exp(torch.where(valid[None], s - safe_m[..., None], float("-inf")))
        denom = denom * scale + wgt.sum(dim=-1)
        if rate > 0.0:
            bidx = torch.arange(b, device=dev)[:, None, None, None]
            rows = (gi_c + hash_offset).clamp(min=0)[None, :, :, None]
            cols = (gj.clamp(0, n - 1) + hash_offset).clamp(min=0)[None, :, None, :]
            keep = hash_u32(seed, bidx, rows, cols) < keep_below
            wgt = torch.where(keep, wgt / (1.0 - rate), 0.0)
        acc = acc * scale[..., None] + torch.matmul(wgt, vd)
        return m_new, denom, acc

    f32 = dict(dtype=torch.float32, device=dev)
    carry = (torch.full((b, M, B), float("-inf"), **f32), torch.zeros((b, M, B), **f32),
             torch.zeros((b, M, B, dv), **f32))
    seed = dropout_seed
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1)[:1]
    elif seed is not None:
        seed = int(seed)
    train = recompute and torch.is_grad_enabled()
    for d in range(-D, D + 1):
        args = (d, *carry, pB, qB, vB, af, bias, kvB, seed)
        carry = _RecomputedStep.apply(step, *args) if train else step(*args)
    _, denom, acc = carry
    out = acc / torch.where(denom > 0, denom, 1.0)[..., None]
    out = out.reshape(b, M * B, dv)[:, :n]
    return torch.sigmoid(out).to(v.dtype)


# ---------------------------------------------------------------------------
# COO layout: scores per edge, segment softmax over destinations
# ---------------------------------------------------------------------------


def gatv2_scores_coo(graph: Graph, p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """Per-edge GATv2 scores, (b, E) float32."""
    z = leaky_relu(p[:, graph.dst, :] + q[:, graph.src, :], alpha)
    return torch.matmul(z.float(), a.float())


def gatv1_scores_coo(graph: Graph, wx: torch.Tensor, a_left: torch.Tensor,
                     a_right: torch.Tensor, alpha: float) -> torch.Tensor:
    """Per-edge GATv1 scores e_ij = leakyrelu(u_i + w_j), (b, E) float32."""
    u = torch.matmul(wx.float(), a_left.float())
    w = torch.matmul(wx.float(), a_right.float())
    return leaky_relu(u[:, graph.dst] + w[:, graph.src], alpha)


def gat_aggregate_coo(
    graph: Graph,
    scores: torch.Tensor,           # (b, E)
    values: torch.Tensor,           # (b, N, d)
    bias: Optional[torch.Tensor],   # (N, N) or None, gathered per edge
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Segment softmax over destinations, dropout, sum of the weighted
    source values per destination, sigmoid. (b, N, d)."""
    if bias is not None:
        scores = scores + bias[graph.dst, graph.src][None, :].float()
    att = _dropout(segment_softmax(scores.float(), graph.dst, graph.n_nodes),
                   dropout_rate, generator)
    msgs = att[..., None] * values[:, graph.src, :].float()           # (b, E, d)
    h = segment_sum(msgs, graph.dst, graph.n_nodes, dim=1)
    return torch.sigmoid(h.to(values.dtype))
