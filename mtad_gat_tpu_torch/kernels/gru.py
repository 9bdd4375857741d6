"""Fused GRU scan: the CUDA kernels ``csrc/gru_fwd.cu`` (forward, K3) and
``csrc/gru_bwd.cu`` (backward through time, K4), their plain PyTorch
versions, and ``gru_scan``, the differentiable call that joins them.

Replaces ``mtad_gat_tpu/kernels/gru_pallas.py``: ``_gru_fwd_kernel`` (the
forward of ``gru_scan_fused``, launched by ``_fwd_launch``),
``_gru_bwd_kernel`` (launched by ``_gru_scan_bwd``) and the custom VJP
``_gru_scan`` around them. The whole recurrence runs in one launch, torch's
cell

    r = sigmoid(gi_r + h W_hr + b_hr)
    z = sigmoid(gi_z + h W_hz + b_hz)
    n = tanh(gi_n + r * (h W_hn + b_hn))
    h' = (1 - z) n + z h

with ``gi = x W_ih + b_ih`` computed by the caller (``nn/gru.py``), whose
gradient autograd takes from ``dgi``.

What bounds it on the card: the steps are serial, so a step's latency sets
the time, not the card's throughput. W_hh is 270 KB at hidden 150, more than
a block's 227 KB of shared memory, so each kernel has two variants and
``gru_plan`` picks one from the width. The cluster variant gives a tile of
batch rows to a thread-block cluster whose blocks each own a slice of the
hidden units (``unit_slices``) and keep that slice of W_hh in shared memory
for all steps; the blocks exchange the step's new state (forward) or gate
gradients (backward) through distributed shared memory, one cluster barrier a
step. The streaming variant, for the widths the cluster cannot hold, keeps
the state in one block and reads W_hh from L2 on every step. The backward
recomputes the gates from the saved states beside the chain that carries the
gradient, and forms dW_hh and db_hh off the serial chain, through partial
sums added in a fixed order (``csrc/gru_bwd.cu`` says more). The TPU kernels'
128-lane and 8-row padding is not carried over: the CUDA kernels mask their
ragged batch tile and their ragged unit slices.

K3 and K4 also take an entity axis (fleet serving and fleet training):
W_hh (G, H, 3H) and b_hh (G, 3H), group g's weights for rows g B/G ..
(g+1) B/G - 1, in one launch whose batch tiles never straddle two groups
(``group_tiles``); K4's weights product sums each group's rows into its own
dW_hh (G, H, 3H) and db_hh (G, 3H). Under ``torch.func.vmap`` the forward
and the backward are custom ops whose vmap rules fold the entities into that
axis (``kernels/_vmap.py``), and ``gru_scan``'s autograd Function lets vmap
run its forward and backward, so ``vmap(grad(...))`` over a fleet launches
K3, K4's scan and K4's weights product once each whatever E is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from mtad_gat_tpu_torch.kernels import _build, _vmap

_SMEM_LIMIT = 227 * 1024          # shared memory a block may use on the card

# The cluster kernels' tiling, as in csrc/gru_cluster.cuh.
CLUSTER_THREADS = 512
CLUSTER_STAGE = 8                 # registers that stage one (H, rows) buffer
MAX_CLUSTER = 8                   # the portable cluster size
# Blocks per cluster tried first, batch rows per cluster and most partial sums
# per column of the step product (the last two are constants of the CUDA
# sources, checked at launch): measured at hidden 150, batch 256 on the H100
# (PERF.md).
K3_CLUSTER, K3_BATCH_TILE, K3_SPLIT = 4, 12, 8
K4_CLUSTER, K4_BATCH_TILE, K4_SPLIT = 5, 12, 4
STREAM_BATCH_TILE = 8             # batch rows per block of the streaming kernels


def unit_slices(hid_dim: int, cluster: int) -> List[Tuple[int, int]]:
    """(start, count) of the hidden units each block of a cluster owns, for
    all three gates: contiguous, the first ``hid_dim % cluster`` blocks one
    unit longer; a block's count is 0 where the cluster outnumbers the units."""
    base, rem = divmod(hid_dim, cluster)
    return [(c * base + min(c, rem), base + (c < rem)) for c in range(cluster)]


def cluster_tiling(hid_dim: int, cluster: int, max_split: int) -> Tuple[int, int, int, int, int]:
    """(units, gate_cols, stride, groups_pad, split) of a cluster kernel's
    step product: most units a block owns; those rounded up to 4, the columns
    of one gate in the block's slice of W_hh; floats between rows of the slice
    (at least three gates, and an odd number of 4-column groups); the groups
    rounded up to whole warps; and the partial sums per column that 512
    threads and ``max_split`` allow."""
    units = -(-hid_dim // cluster)
    gate_cols = -(-units // 4) * 4
    stride = 3 * gate_cols
    if stride // 4 % 2 == 0:
        stride += 4
    groups_pad = -(-(stride // 4) // 32) * 32
    split = max(1, min(CLUSTER_THREADS // groups_pad, max_split, hid_dim))
    return units, gate_cols, stride, groups_pad, split


def gru_smem_bytes(kernel: str, hid_dim: int, cluster: int) -> int:
    """Bytes of shared memory one block of K3 (``kernel`` "fwd") or of K4's
    scan ("bwd") needs at this width in a cluster of ``cluster`` blocks, or
    (cluster 0) in the streaming variant."""
    H = hid_dim
    if cluster == 0:
        return 4 * STREAM_BATCH_TILE * H * (4 if kernel == "fwd" else 12)
    if kernel == "fwd":     # h (two buffers), partial sums, the W_hh slice, its bias
        rows = K3_BATCH_TILE
        _, _, stride, _, split = cluster_tiling(H, cluster, K3_SPLIT)
        return 4 * (2 * H * rows + split * rows * stride + H * stride + stride)
    rows = K4_BATCH_TILE    # h and dg (two buffers each), two sets of partial sums, two slices
    _, _, stride, _, split = cluster_tiling(H, cluster, K4_SPLIT)
    return 4 * (2 * H * rows + 6 * H * rows + 2 * split * rows * stride + 2 * H * stride
                + stride)


def _cluster_holds(kernel: str, hid_dim: int, cluster: int, smem_limit: int) -> bool:
    """Whether a cluster of this size can run the width: a thread per (batch
    row, own unit), the staging registers, and the block's shared memory."""
    rows = K3_BATCH_TILE if kernel == "fwd" else K4_BATCH_TILE
    return (rows * -(-hid_dim // cluster) <= CLUSTER_THREADS
            and hid_dim * rows <= CLUSTER_STAGE * CLUSTER_THREADS
            and gru_smem_bytes(kernel, hid_dim, cluster) <= smem_limit)


def gru_plan(kernel: str, hid_dim: int, smem_limit: int = _SMEM_LIMIT,
             max_cluster: int = MAX_CLUSTER) -> Tuple[str, int]:
    """Which variant of K3 ("fwd") or of K4's scan ("bwd") runs at this
    width on a card whose blocks may use ``smem_limit`` bytes of shared
    memory and whose clusters hold up to ``max_cluster`` blocks: ("cluster",
    blocks per cluster) where a block's slice of W_hh fits on chip, at the
    measured cluster size first and at the largest one otherwise; else
    ("streaming", 0). Raises where no variant can hold the width."""
    if kernel not in ("fwd", "bwd"):
        raise ValueError(f"gru_plan: kernel {kernel!r} is neither 'fwd' nor 'bwd'")
    if hid_dim < 1:
        raise ValueError("gru_plan: empty hidden state")
    prefer = K3_CLUSTER if kernel == "fwd" else K4_CLUSTER
    for cluster in sorted({min(prefer, max_cluster), max_cluster}):
        if _cluster_holds(kernel, hid_dim, cluster, smem_limit):
            return "cluster", cluster
    if gru_smem_bytes(kernel, hid_dim, 0) <= smem_limit:
        return "streaming", 0
    raise ValueError(f"gru_plan: hidden width {hid_dim} needs more shared memory "
                     "than a block has")


def group_tiles(rows_per_group: int, groups: int, tile: int) -> List[Tuple[int, int, int]]:
    """(group, first row, rows) of each batch tile of a grouped launch, in
    launch order, as ``csrc/gru_fwd.cu`` lays them out: each group's rows
    cut into tiles of ``tile``, the last one ragged, no tile across two
    groups; G ceil(rows_per_group / tile) tiles."""
    per = -(-rows_per_group // tile)
    return [(g, g * rows_per_group + t * tile, min(tile, rows_per_group - t * tile))
            for g in range(groups) for t in range(per)]


def weight_groups(B: int, w_hh: torch.Tensor, b_hh: torch.Tensor, hid_dim: int,
                  name: str) -> int:
    """Groups G of a K3 call: 1 for w_hh (H, 3H) and b_hh (3H,); G for
    (G, H, 3H) and (G, 3H), which needs B a multiple of G. Raises on any
    other shape."""
    H = hid_dim
    if w_hh.shape == (H, 3 * H) and b_hh.shape == (3 * H,):
        return 1
    G = w_hh.shape[0] if w_hh.dim() == 3 else 0
    if G < 1 or w_hh.shape != (G, H, 3 * H) or b_hh.shape != (G, 3 * H) or B % G:
        raise ValueError(
            f"{name}: w_hh {tuple(w_hh.shape)} and b_hh {tuple(b_hh.shape)} are neither "
            f"({H}, {3 * H}) and ({3 * H},) nor G groups (G, {H}, {3 * H}) and "
            f"(G, {3 * H}) with the batch {B} a multiple of G")
    return G


def _check_plan(lib_tile: int, lib_bytes: int, tile: int, nbytes: int, what: str) -> None:
    """The planner mirrors constants of the CUDA source: refuse to launch
    where the two have drifted apart."""
    if (lib_tile, lib_bytes) != (tile, nbytes):
        raise RuntimeError(
            f"{what}: the planner expects a batch tile of {tile} and {nbytes} bytes of "
            f"shared memory, the built kernel has {lib_tile} and {lib_bytes}")


def gru_step(
    g: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """One step of the cell above in the inputs' type: g (B, 3H) is the
    step's input projection, h (B, H) the carry, w_hh (H, 3H)."""
    H = h.shape[-1]
    gh = h @ w_hh + b_hh
    r = torch.sigmoid(g[:, :H] + gh[:, :H])
    z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def gru_scan_fwd_plain(
    gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, hid_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain tensor ops, in float32: returns
    (hseq (B, T, H) float32, h_last (B, H)). Grouped weights (G, H, 3H)
    and (G, 3H) (``weight_groups``) run one group of B / G rows at a time."""
    B, T, _ = gi.shape
    G = weight_groups(B, w_hh, b_hh, hid_dim, "gru_scan_fwd_plain")
    if G > 1:
        rows = B // G
        hseq = torch.cat([gru_scan_fwd_plain(gi[g * rows:(g + 1) * rows], w_hh[g], b_hh[g],
                                             hid_dim)[0] for g in range(G)])
        return hseq, hseq[:, -1, :]
    w, b = w_hh.reshape(hid_dim, -1).float(), b_hh.reshape(-1).float()
    h = torch.zeros((B, hid_dim), dtype=torch.float32, device=gi.device)
    outs = []
    for t in range(T):
        h = gru_step(gi[:, t].float(), h, w, b)
        outs.append(h)
    hseq = torch.stack(outs, dim=1)
    return hseq, hseq[:, -1, :]


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_fwd")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.gru_fwd_f32, lib.gru_fwd_bf16):
            fn.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
            fn.restype = i32
        lib.gru_fwd_tiles.argtypes = [i32] * 3
        lib.gru_fwd_tiles.restype = ctypes.c_long
        lib.gru_fwd_smem_bytes.argtypes = [i32, i32]
        lib.gru_fwd_smem_bytes.restype = ctypes.c_long
        lib.gru_fwd_batch_tile.argtypes = []
        lib.gru_fwd_batch_tile.restype = i32
        lib._typed = True
    return lib


def gru_scan_fwd(
    gi: torch.Tensor,      # (B, T, 3H): precomputed x @ W_ih + b_ih
    w_hh: torch.Tensor,    # (H, 3H), gate order (r, z, n); or (G, H, 3H)
    b_hh: torch.Tensor,    # (3H,); or (G, 3H)
    hid_dim: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: run the GRU recurrence in one launch. Returns (hseq (B, T, H)
    float32, h_last (B, H)). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises: the variant ``gru_plan`` names for
    the width, recorded in ``gru_scan_fwd.last_launch``. Grouped weights
    (``weight_groups``) give rows g B/G .. (g+1) B/G - 1 group g's W_hh and
    b_hh in the same launch; under ``torch.func`` transforms the call is
    the custom op ``gru_scan_fwd_op``, whose vmap rule folds the entities
    into those groups. It has no backward of its own: where autograd would
    record the call it raises, and ``gru_scan`` is the differentiable call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gi, w_hh, b_hh)):
        raise RuntimeError(
            "gru_scan_fwd launches the forward kernel alone and records no "
            "gradient: call gru_scan, or run it under torch.no_grad()")
    if _vmap.is_wrapped(gi, w_hh, b_hh):
        hseq = gru_scan_fwd_op(gi, w_hh, b_hh, hid_dim)
        return hseq, hseq[:, -1, :]
    if gi.device.type == "cpu":
        return gru_scan_fwd_plain(gi, w_hh, b_hh, hid_dim)
    if gi.device.type != "cuda":
        raise ValueError(f"gru_scan_fwd: unsupported device {gi.device}")
    B, T, G3 = gi.shape
    H = hid_dim
    if G3 != 3 * H:
        raise ValueError(
            f"gru_scan_fwd: shapes gi {tuple(gi.shape)} w_hh {tuple(w_hh.shape)} "
            f"b_hh {tuple(b_hh.shape)} do not fit hidden width {H}")
    groups = weight_groups(B, w_hh, b_hh, H, "gru_scan_fwd")
    if gi.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("gru_scan_fwd: gi must be float32 or bfloat16")
    if w_hh.device != gi.device or b_hh.device != gi.device:
        raise ValueError("gru_scan_fwd: all tensors must be on one device")
    if T == 0 or H == 0:
        raise ValueError("gru_scan_fwd: empty sequence or hidden state")
    hseq = torch.empty((B, T, H), dtype=torch.float32, device=gi.device)
    if B == 0:
        return hseq, hseq[:, -1, :]
    variant, cluster = gru_plan("fwd", H)
    nbytes = gru_smem_bytes("fwd", H, cluster)
    lib = _lib()
    _check_plan(lib.gru_fwd_batch_tile(), lib.gru_fwd_smem_bytes(H, cluster),
                K3_BATCH_TILE, nbytes, "gru_scan_fwd")
    gi = gi.contiguous()
    w = w_hh.to(torch.float32).contiguous()
    b = b_hh.to(torch.float32).contiguous()
    fn = lib.gru_fwd_f32 if gi.dtype == torch.float32 else lib.gru_fwd_bf16
    with torch.cuda.device(gi.device):
        err = fn(
            gi.data_ptr(), w.data_ptr(), b.data_ptr(), hseq.data_ptr(), B, T, H, cluster,
            B // groups, torch.cuda.current_stream(gi.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_fwd {variant} kernel launch failed: CUDA error {err}")
    gru_scan_fwd.launches += 1
    gru_scan_fwd.last_launch = {"variant": variant, "cluster": cluster,
                                "smem_bytes": nbytes, "groups": groups}
    return hseq, hseq[:, -1, :]


gru_scan_fwd.launches = 0
gru_scan_fwd.last_launch = None


@torch.library.custom_op("mtad_gat_tpu_torch::gru_scan_fwd", mutates_args=())
def gru_scan_fwd_op(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                    hid_dim: int) -> torch.Tensor:
    """``gru_scan_fwd``'s hseq as a custom op, the form a vmapped call
    takes (its vmap rule below)."""
    return gru_scan_fwd(gi, w_hh, b_hh, hid_dim)[0]


def _gru_scan_fwd_vmap(info, in_dims, gi, w_hh, b_hh, hid_dim):
    """The entities' rows folded into one batch, their weights into K3's
    groups (``kernels/_vmap.py``): one grouped call whatever E is."""
    G = info.batch_size
    gi_dim, w_dim, b_dim, _ = in_dims
    hseq, _ = gru_scan_fwd(_vmap.fold_rows(gi, gi_dim, G),
                           _vmap.fold_weight(w_hh, w_dim, G, 2),
                           _vmap.fold_weight(b_hh, b_dim, G, 1), hid_dim)
    _gru_scan_fwd_vmap.calls += 1
    return _vmap.unfold_rows(hseq, G), 0


_gru_scan_fwd_vmap.calls = 0
gru_scan_fwd_op.register_vmap(_gru_scan_fwd_vmap)


# ---------------------------------------------------------------------------
# K4: the backward through time, mtad_gat_tpu/kernels/gru_pallas.py:74-137
# ---------------------------------------------------------------------------


def gru_scan_bwd_plain(
    gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
    hseq: torch.Tensor, dhseq: torch.Tensor, hid_dim: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function step by step in plain tensor ops, in
    float32: from the saved states hseq (B, T, H) and the cotangent dhseq
    (B, T, H), returns (dgi (B, T, 3H), dw_hh (H, 3H), db_hh (3H,)).
    Grouped weights (G, H, 3H) and (G, 3H) (``weight_groups``) run one group
    of B / G rows at a time and give dw_hh (G, H, 3H) and db_hh (G, 3H)."""
    B, T, _ = gi.shape
    H = hid_dim
    G = weight_groups(B, w_hh, b_hh, H, "gru_scan_bwd_plain")
    if w_hh.dim() == 3:
        rows = B // G
        parts = [gru_scan_bwd_plain(gi[g * rows:(g + 1) * rows], w_hh[g], b_hh[g],
                                    hseq[g * rows:(g + 1) * rows],
                                    dhseq[g * rows:(g + 1) * rows], H) for g in range(G)]
        return tuple(torch.cat([p[0] for p in parts]) if i == 0
                     else torch.stack([p[i] for p in parts]) for i in range(3))
    w, b = w_hh.float(), b_hh.float()
    hseq = hseq.float()
    dgi = torch.empty((B, T, 3 * H), dtype=torch.float32, device=gi.device)
    dw = torch.zeros((H, 3 * H), dtype=torch.float32, device=gi.device)
    db = torch.zeros((3 * H,), dtype=torch.float32, device=gi.device)
    dh = torch.zeros((B, H), dtype=torch.float32, device=gi.device)
    for t in reversed(range(T)):
        h_prev = hseq[:, t - 1] if t > 0 else torch.zeros_like(dh)
        g = gi[:, t].float()
        gh = h_prev @ w + b
        r = torch.sigmoid(g[:, :H] + gh[:, :H])
        z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
        dh = dh + dhseq[:, t].float()
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        dz_pre = dh * (h_prev - n) * z * (1.0 - z)
        dr_pre = dn_pre * gh[:, 2 * H:] * r * (1.0 - r)
        dgi[:, t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1)
        dgh = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=1)
        dh = dh * z + dgh @ w.t()
        dw += h_prev.t() @ dgh
        db += dgh.sum(dim=0)
    return dgi, dw, db


# K4's weights product, as in csrc/gru_bwd.cu: a thread's 8 x 8 register
# tile, the most such tiles along a block tile's rows and along its
# columns, the reduction rows of one cp.async stage, the stages of the ring,
# and the registers a thread may use (its launch bounds).
W_MICRO, W_SIDE_M, W_SIDE_N, W_RM, W_STAGES, W_REGISTERS = 8, 20, 20, 16, 3, 128
# One multiprocessor of the card: registers, shared memory, threads, and the
# shared memory the system keeps per block.
_SM_REGISTERS, _SM_SMEM, _SM_THREADS, _BLOCK_RESERVED = 65536, 228 * 1024, 2048, 1024


def weight_grad_tiling(hid_dim: int) -> Tuple[int, int, int, int, int, int]:
    """(TY, TX, row tiles, column tiles a gate, threads, shared memory bytes)
    of K4's dW_hh product at this width: a block tile is 8 TY rows of the
    H + 1 rows of (dW_hh; db_hh) by 8 TX columns of one gate, each side
    covered by as few tiles of at most ``W_SIDE_M`` (``W_SIDE_N``) register
    tiles as it can be; a thread a register tile and at least one a column
    of a stage."""
    mr = -(-(hid_dim + 1) // W_MICRO)
    rt = -(-mr // W_SIDE_M)
    ty = -(-mr // rt)
    mc = -(-hid_dim // W_MICRO)
    ct = -(-mc // W_SIDE_N)
    tx = -(-mc // ct)
    threads = -(-max(ty * tx, W_MICRO * max(ty, tx)) // 32) * 32
    smem = 4 * W_STAGES * W_RM * W_MICRO * (ty + tx)
    return ty, tx, rt, ct, threads, smem


def weight_grad_chunks(rows: int, hid_dim: int, sms: int,
                       tiling: Optional[Tuple[int, ...]] = None, groups: int = 1) -> int:
    """Row chunks of K4's dW_hh product on a card of ``sms``
    multiprocessors: its (H + 1, 3H) output gives few block tiles (three at
    hidden 150), so the B * T rows are split until the blocks fill the card
    in one wave at as many blocks a multiprocessor as its registers, shared
    memory and threads hold (one at hidden 150), each chunk at least one
    stage. With ``groups`` G, ``rows`` are one group's and the count S is a
    group's: the G S chunks run in waves of the card's fill, so S is the
    least whose waves times a chunk's rows lies within 5% of the best
    (3 at G 28 and hidden 150 on 132 multiprocessors: 84 chunks in two waves
    of 44, where 2 would leave the second wave a quarter full). ``tiling``
    is ``weight_grad_tiling``'s, or a sweep's own build's."""
    _, _, rt, ct, threads, smem = tiling or weight_grad_tiling(hid_dim)
    per_sm = max(1, min(_SM_REGISTERS // (W_REGISTERS * threads),
                        _SM_SMEM // (smem + _BLOCK_RESERVED), _SM_THREADS // threads))
    fill = sms * per_sm // (3 * rt * ct)
    most = max(1, min(-(-rows // W_RM), fill))
    if groups == 1:
        return most

    def cost(s):        # waves of the G s chunks, times a chunk's rows
        return -(-groups * s // fill) / s

    best = min(cost(s) for s in range(1, most + 1))
    return next(s for s in range(1, most + 1) if cost(s) <= 1.05 * best)


@functools.lru_cache(maxsize=None)
def _check_weights_tiling(hid_dim: int) -> None:
    """Refuse to launch where the built weights kernel's tiling and this
    module's mirror of it have drifted apart (once per width)."""
    out = (ctypes.c_int * 6)()
    _bwd_lib().gru_bwd_weights_tiling(hid_dim, out)
    if tuple(out) != weight_grad_tiling(hid_dim):
        raise RuntimeError(f"gru_weight_grads: the built kernel's tiling {tuple(out)} "
                           f"differs from this module's {weight_grad_tiling(hid_dim)}")


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("gru_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.gru_bwd_scan_f32, lib.gru_bwd_scan_bf16):
            fn.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
            fn.restype = i32
        lib.gru_bwd_weights.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.gru_bwd_weights.restype = i32
        lib.gru_bwd_tiles.argtypes = [i32] * 3
        lib.gru_bwd_tiles.restype = ctypes.c_long
        lib.gru_bwd_weights_tiling.argtypes = [i32, ptr]
        lib.gru_bwd_weights_tiling.restype = None
        lib.gru_bwd_smem_bytes.argtypes = [i32, i32]
        lib.gru_bwd_smem_bytes.restype = ctypes.c_long
        lib.gru_bwd_batch_tile.argtypes = []
        lib.gru_bwd_batch_tile.restype = i32
        lib._typed = True
    return lib


def gru_weight_grads_plain(
    hseq: torch.Tensor, dgi: torch.Tensor, dghn: torch.Tensor, hid_dim: int,
    groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's weights product in plain tensor ops, float32, step by step as
    ``gru_scan_bwd_plain`` accumulates it: dW_hh = sum over t >= 1 of
    h_{t-1}^T dgh_t and db_hh = the sum of dgh over every step and batch row,
    with dgh = (dgi[..., :2H], dghn). With ``groups`` G > 1 each group of
    B / G rows is summed alone: dW_hh (G, H, 3H) and db_hh (G, 3H)."""
    H = hid_dim
    if groups > 1:
        rows = dgi.shape[0] // groups
        parts = [gru_weight_grads_plain(*(t[g * rows:(g + 1) * rows] for t in (hseq, dgi, dghn)),
                                        H) for g in range(groups)]
        return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    dgh = torch.cat([dgi[..., :2 * H].float(), dghn.float()], dim=-1)
    dw = torch.zeros((H, 3 * H), dtype=torch.float32, device=dgi.device)
    db = torch.zeros((3 * H,), dtype=torch.float32, device=dgi.device)
    for t in range(dgi.shape[1]):
        if t > 0:
            dw += hseq[:, t - 1].float().t() @ dgh[:, t]
        db += dgh[:, t].sum(dim=0)
    return dw, db


def gru_weight_grads(
    hseq: torch.Tensor,    # (B, T, H) float32, the forward's states
    dgi: torch.Tensor,     # (B, T, 3H) float32, the scan's input-side gate gradients
    dghn: torch.Tensor,    # (B, T, H) float32, the scan's dn_pre * r
    hid_dim: int,
    groups: int = 1,
    chunks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's weights product on contiguous float32 CUDA tensors: (dW_hh (H,
    3H), db_hh (3H,)) as ``gru_weight_grads_plain`` computes them, through
    ``weight_grad_chunks`` row chunks and a fixed-order sum of their
    partials. With ``groups`` G > 1 (B a multiple of G) each group's rows are
    chunked and summed on their own into dW_hh (G, H, 3H) and db_hh (G, 3H),
    in one launch. ``chunks`` forces the chunks a group (a grouped launch
    gives each group the bits of an ungrouped launch on its rows with the
    same count). ``gru_scan_bwd`` calls it after the scan."""
    H = hid_dim
    B, T, _ = dgi.shape
    dev = dgi.device
    if dev.type != "cuda":
        raise ValueError(f"gru_weight_grads: unsupported device {dev}")
    if hseq.shape != (B, T, H) or dgi.shape != (B, T, 3 * H) or dghn.shape != (B, T, H):
        raise ValueError(f"gru_weight_grads: shapes hseq {tuple(hseq.shape)} dgi "
                         f"{tuple(dgi.shape)} dghn {tuple(dghn.shape)} do not fit hidden "
                         f"width {H}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev
           for t in (hseq, dgi, dghn)):
        raise ValueError("gru_weight_grads: hseq, dgi and dghn must be contiguous float32 "
                         "tensors on one device")
    if groups < 1 or B % groups:
        raise ValueError(f"gru_weight_grads: {groups} groups do not divide the batch {B}")
    _check_weights_tiling(H)
    rows = B // groups
    S = chunks or weight_grad_chunks(rows * T, H, _build.sm_count(dev), groups=groups)
    part = torch.empty((groups * S, H + 1, 3 * H), dtype=torch.float32, device=dev)
    lead = (groups,) if groups > 1 else ()
    dw = torch.empty((*lead, H, 3 * H), dtype=torch.float32, device=dev)
    db = torch.empty((*lead, 3 * H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _bwd_lib().gru_bwd_weights(
            hseq.data_ptr(), dgi.data_ptr(), dghn.data_ptr(), part.data_ptr(), dw.data_ptr(),
            db.data_ptr(), B, T, H, S, rows, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gru_bwd weights kernel launch failed: CUDA error {err}")
    gru_weight_grads.launches += 1
    gru_weight_grads.last_launch = {"groups": groups, "chunks": S}
    return dw, db


gru_weight_grads.launches = 0
gru_weight_grads.last_launch = None


def gru_scan_bwd(
    gi: torch.Tensor,      # (B, T, 3H), float32 or bfloat16
    w_hh: torch.Tensor,    # (H, 3H); or (G, H, 3H)
    b_hh: torch.Tensor,    # (3H,); or (G, 3H)
    hseq: torch.Tensor,    # (B, T, H) float32, the forward's output
    dhseq: torch.Tensor,   # (B, T, H), any strides
    hid_dim: int,
    need_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K4 on CUDA tensors: (dgi (B, T, 3H) float32, dw_hh (H, 3H), db_hh
    (3H,)), the last two None when ``need_weights`` is off and only the
    scan runs: the variant ``gru_plan`` names for the width, recorded in
    ``gru_scan_bwd.last_launch``, then ``gru_weight_grads``. Grouped weights
    (``weight_groups``) give rows g B/G .. (g+1) B/G - 1 group g's W_hh and
    b_hh in the same launches, and dw_hh (G, H, 3H), db_hh (G, 3H). The CPU
    computes the same in ``gru_scan_bwd_plain``."""
    if gi.device.type != "cuda":
        raise ValueError(f"gru_scan_bwd: unsupported device {gi.device}")
    B, T, G3 = gi.shape
    H = hid_dim
    if G3 != 3 * H or hseq.shape != (B, T, H) or dhseq.shape != (B, T, H):
        raise ValueError(
            f"gru_scan_bwd: shapes gi {tuple(gi.shape)} w_hh {tuple(w_hh.shape)} "
            f"b_hh {tuple(b_hh.shape)} hseq {tuple(hseq.shape)} dhseq "
            f"{tuple(dhseq.shape)} do not fit hidden width {H}")
    groups = weight_groups(B, w_hh, b_hh, H, "gru_scan_bwd")
    if gi.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("gru_scan_bwd: gi must be float32 or bfloat16")
    if any(t.device != gi.device for t in (w_hh, b_hh, hseq, dhseq)):
        raise ValueError("gru_scan_bwd: all tensors must be on one device")
    if T == 0 or H == 0:
        raise ValueError("gru_scan_bwd: empty sequence or hidden state")
    dev = gi.device
    dgi = torch.empty((B, T, 3 * H), dtype=torch.float32, device=dev)
    if B == 0:
        if not need_weights:
            return dgi, None, None
        return (dgi, torch.zeros(w_hh.shape, device=dev),
                torch.zeros(b_hh.shape, device=dev))
    variant, cluster = gru_plan("bwd", H)
    nbytes = gru_smem_bytes("bwd", H, cluster)
    lib = _bwd_lib()
    _check_plan(lib.gru_bwd_batch_tile(), lib.gru_bwd_smem_bytes(H, cluster),
                K4_BATCH_TILE, nbytes, "gru_scan_bwd")
    gi = gi.detach().contiguous()
    w = w_hh.detach().to(torch.float32).contiguous()
    # a second, transposed copy (a layout, not arithmetic) so that the scan
    # reads W_hh along its rows for both of its products (the cluster scan
    # once per launch, into shared memory); free when w_hh is the transposed
    # view of an nn.GRU-layout parameter; (G, 3H, H) when grouped
    w_t = w_hh.detach().to(torch.float32).transpose(-2, -1).contiguous()
    b = b_hh.detach().to(torch.float32).contiguous()
    hseq = hseq.detach().to(torch.float32).contiguous()
    dhseq = dhseq.detach().to(torch.float32).contiguous()
    dghn = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scan = lib.gru_bwd_scan_f32 if gi.dtype == torch.float32 else lib.gru_bwd_scan_bf16
    with torch.cuda.device(dev):
        err = scan(gi.data_ptr(), w.data_ptr(), w_t.data_ptr(), b.data_ptr(),
                   hseq.data_ptr(), dhseq.data_ptr(), dgi.data_ptr(), dghn.data_ptr(),
                   B, T, H, cluster, B // groups, stream)
        if err != 0:
            raise RuntimeError(
                f"gru_bwd {variant} scan kernel launch failed: CUDA error {err}")
    gru_scan_bwd.launches += 1
    gru_scan_bwd.last_launch = {"variant": variant, "cluster": cluster,
                                "smem_bytes": nbytes, "groups": groups}
    if not need_weights:
        return dgi, None, None
    dw, db = gru_weight_grads(hseq, dgi, dghn, H, groups)
    return dgi, dw.view(w_hh.shape), db.view(b_hh.shape)


gru_scan_bwd.launches = 0
gru_scan_bwd.last_launch = None


@torch.library.custom_op("mtad_gat_tpu_torch::gru_scan_bwd", mutates_args=())
def gru_scan_bwd_op(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                    hseq: torch.Tensor, dhseq: torch.Tensor,
                    hid_dim: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4, weights included, as a custom op, the form a vmapped backward
    takes (its vmap rule below): ``gru_scan_bwd`` on a CUDA tensor, its
    plain version on a CPU one."""
    if gi.device.type == "cpu":
        return gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, hid_dim)
    return gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, hid_dim)


def _gru_scan_bwd_vmap(info, in_dims, gi, w_hh, b_hh, hseq, dhseq, hid_dim):
    """The entities' rows folded into one batch, their weights into K4's
    groups: one grouped scan and one grouped weights product whatever E is,
    each entity's dW_hh and db_hh its own."""
    G = info.batch_size
    gi_dim, w_dim, b_dim, h_dim, d_dim, _ = in_dims
    w = _vmap.fold_weight(w_hh, w_dim, G, 2)
    b = _vmap.fold_weight(b_hh, b_dim, G, 1)
    dgi, dw, db = gru_scan_bwd_op(
        _vmap.fold_rows(gi, gi_dim, G), w, b, _vmap.fold_rows(hseq, h_dim, G),
        _vmap.fold_rows(dhseq, d_dim, G), hid_dim)
    _gru_scan_bwd_vmap.calls += 1
    # nested vmaps: an entity's weights were already grouped, so are its grads
    lead = (G,) if w_hh.dim() - (w_dim is not None) == 2 else (G, -1)
    return ((_vmap.unfold_rows(dgi, G), dw.reshape(*lead, *dw.shape[-2:]),
             db.reshape(*lead, db.shape[-1])), (0, 0, 0))


_gru_scan_bwd_vmap.calls = 0
gru_scan_bwd_op.register_vmap(_gru_scan_bwd_vmap)


# ---------------------------------------------------------------------------
# The differentiable call: mtad_gat_tpu/kernels/gru_pallas.py::_gru_scan
# (custom VJP, :172-249).
# ---------------------------------------------------------------------------


class _GRUScan(torch.autograd.Function):
    """K3 forward, K4 backward. ``torch.func`` transforms it too: under
    them its forward is K3's custom op and its backward K4's (the ops take
    the transforms' wrapped tensors apart), under vmap each folding the
    entities into one grouped launch (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(gi, w_hh, b_hh, hid_dim):
        return gru_scan_fwd(gi, w_hh, b_hh, hid_dim)[0]   # grad mode is off here

    @staticmethod
    def setup_context(ctx, inputs, output):
        gi, w_hh, b_hh, hid_dim = inputs
        ctx.save_for_backward(gi, w_hh, b_hh, output)
        ctx.hid_dim = hid_dim

    @staticmethod
    def backward(ctx, dhseq):
        gi, w_hh, b_hh, hseq = ctx.saved_tensors
        if not _vmap.is_wrapped(gi, w_hh, b_hh, hseq, dhseq):
            return _GRUScan._solo_backward(ctx, dhseq)
        with torch.no_grad():
            grads = gru_scan_bwd_op(gi, w_hh, b_hh, hseq, dhseq, ctx.hid_dim)
        return _GRUScan._cast(ctx, *grads)

    @staticmethod
    @once_differentiable
    def _solo_backward(ctx, dhseq):
        """The backward of a call outside ``torch.func`` transforms,
        straight to the wrapper (or its plain version); a second derivative
        through it raises."""
        gi, w_hh, b_hh, hseq = ctx.saved_tensors
        if gi.device.type == "cpu":
            grads = gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, ctx.hid_dim)
        else:
            grads = gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, ctx.hid_dim,
                                 need_weights=any(ctx.needs_input_grad[1:3]))
        return _GRUScan._cast(ctx, *grads)

    @staticmethod
    def _cast(ctx, dgi, dw, db):
        gi, w_hh, b_hh, _ = ctx.saved_tensors
        need_gi, need_w, need_b = ctx.needs_input_grad[:3]
        return (dgi.to(gi.dtype) if need_gi else None,
                dw.to(w_hh.dtype) if need_w else None,
                db.to(b_hh.dtype) if need_b else None, None)


def gru_scan(
    gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, hid_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused GRU scan with gradients: (hseq (B, T, H) float32, h_last
    (B, H)), arguments as ``gru_scan_fwd``. Forward K3 and backward K4 on
    CUDA tensors, their plain versions on CPU tensors; under
    ``torch.func.vmap`` (with ``grad`` inside or not) each a grouped launch
    for all entities. The backward is not itself differentiable (an
    unbatched call's second derivative raises)."""
    if _vmap.requires_grad(gi, w_hh, b_hh):
        hseq = _GRUScan.apply(gi, w_hh, b_hh, hid_dim)
        return hseq, hseq[:, -1, :]
    return gru_scan_fwd(gi, w_hh, b_hh, hid_dim)
