"""Fused GATv2 attention: the CUDA kernels ``csrc/gat_fwd.cu`` (forward) and
``csrc/gat_bwd.cu`` (backward), their plain PyTorch versions, and
``gatv2_attention``, the ``torch.autograd.Function`` that trains through them.

For each destination node i of a complete graph:

    out_i = sigmoid( sum_j softmax_j( a . leakyrelu(p_i + q_j) + bias_ij ) v_j )

with attention dropout, in training, on the softmaxed weights of the
aggregate only (scaled by 1/(1-rate), not renormalised). The kernels replace
those of ``mtad_gat_tpu/kernels/gat_pallas.py``:

- K1, ``gatv2_attention_fwd``: ``_kernel`` (scoring, no gradient);
- K1-res, ``gatv2_attention_res``: ``_kernel_res``, the forward that also
  writes the backward's residuals u (pre-sigmoid aggregate), m and l (row
  max and row sum), with in-kernel hash dropout. Both run the whole-graph
  kernel (a batch element's graph, or half its rows, in one block, an exact
  softmax) or the tiled one, as ``gat_fwd_plan`` decides. The tiled one
  launches as ``gat_tiled_fwd_plan`` says: 64 x 64 score tiles of 4 x 4
  register micro-tiles, an online softmax, E and D in chunks (any width),
  the key loop cut into slices whose float32 partials (m, l, aggregate)
  ``gatv2_fwd_merge`` combines in slice order;
- K2a ``gatv2_bwd_dp_da``, K2b ``gatv2_bwd_dq_dv``, K2c ``gatv2_bwd_dbias``:
  ``_bwd_dp_da_kernel``, ``_bwd_dq_dv_kernel``, ``_bwd_dbias_kernel``;
- K2ab ``gatv2_bwd_graph``: K2a and K2b in one launch for a graph that fits
  a block whole (the model's), each (i, j) pair scored once, and K2c's dbias
  in the same pass where the call wants it (a block sums it over a group of
  batch elements, ``dbias_groups``).
  ``gatv2_bwd`` runs K2ab, K2a then K2b, or the streamed backward, as
  ``gat_bwd_route`` decides; dbias comes from the same pass of K2ab, of the
  tiled K2b or of the streamed backward (``dbias_kernel``, K2b's batch
  groups ``tiled_dbias_groups``), and K2c itself runs on no path, only
  where a caller asks for it. The tiled K2a and K2b launch as
  ``gat_tiled_bwd_plan`` says:
  score tiles of 4 x 4 register micro-tiles (E and D streamed in chunks
  beyond the widths whole rows fit: the CHUNKED tile), the streamed loop
  cut into slices of their own blocks, each slice's float32 partial summed
  in slice order by a reduce kernel. No tiled kernel refuses a width: the
  tiled forward, K2a, K2b and K2c stage E and D by chunks where whole rows
  do not fit a block;
- the streamed backward ``gatv2_bwd_streamed`` (``csrc/gat_streamed.cu``):
  K2a, K2b and K2c's functions for a small graph of very wide rows (a
  feature layer beyond window 235), where the tiled plan names the CHUNKED
  tile and N is at most ``streamed_nmax``: a score pass that scores each
  pair once and writes ds and wa (B, N, N), then a contraction pass split
  over the columns of E and D, launched as ``gat_streamed_bwd_plan`` says.

What bounds them on the card: the score is float32 work on the CUDA cores
(4 operations per (i, j, e), recomputed by each tiled backward kernel and
once by K2ab, then one multiply-add per (i, j, e) for each of the
backward's contractions), with no
product structure for the tensor cores; at the model's
graph sizes that work outweighs the bytes of the inputs. Every kernel keeps
its tiles' operands in shared memory and recomputes weights from (m, l), so
no (N, N) tensor is written to device memory except dbias and its partial
sums, one per batch chunk (K2c) or group (K2ab, K2b), one per batch element
only where the tiled K2b needs them all to fill the card;
the tiled K2a and K2b's partials are (slices, B, N, width), linear in N
(``csrc/gat_fwd.cu`` and ``csrc/gat_bwd.cu`` say more). The TPU kernels'
VMEM tiling plan (``_Plan``) and lane padding are not carried over: the CUDA
kernels pick their own tiles and mask ragged edges.

The dropout mask is a hash of the global (seed, batch index, row, column),
bit for bit the JAX package's (``graph/dropout.py``); its plain form is
``hash_keep_mask``. The seed is a one-element int64 tensor on the
device, drawn there from the step's generator, so no launch waits on the host.

K1 and K1-res (whole-graph and tiled), K2ab, the tiled K2a and K2b (every
tile) and the streamed backward also take an entity axis (fleet serving
and fleet training): a (G, E) and bias (G, N, N), group g's for batch
elements g B/G .. (g+1) B/G - 1 (``attention_groups``), one dropout seed a
group and the batch index within the group in the hash, so that each
group's mask is its own call's; the backward's da (G, E) and dbias (G, N,
N) each summed over its group's rows in its own launch's order, no batch
run of a block straddling two groups. Under ``torch.func.vmap`` the no-grad
call is the custom op ``gatv2_attention_fwd_op``, and ``gatv2_attention``'s
Function runs K1-res's op forward and the backward's op backward, whose
rules fold the entities into those groups (``kernels/_vmap.py``).
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from mtad_gat_tpu_torch.graph.dropout import Seed, hash_keep_mask, keep_threshold, seed_int
from mtad_gat_tpu_torch.graph.ops import gat_aggregate_dense, gatv2_scores_dense
from mtad_gat_tpu_torch.kernels import _build, _vmap

# Largest (batch chunk x N x N x E) float32 temporary the plain versions
# build at once, to bound their memory at large batches.
_PLAIN_CHUNK_ELEMS = 1 << 26
_SMEM_LIMIT = 227 * 1024
_BI, _BJ = 16, 32                 # K2c's row and key tiles
DBIAS_CHUNK = 64                  # K2c's staged widths where whole rows do not fit a block

# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card-side oracle of chip_smoke.py)
# ---------------------------------------------------------------------------


def attention_groups(p: torch.Tensor, a: torch.Tensor, bias: Optional[torch.Tensor],
                     name: str) -> int:
    """Groups G of a K1 call on p (B, N, E): 1 for a (E,) and bias (N, N) or
    None; G for a (G, E) and bias (G, N, N) or None, which needs B a
    multiple of G. Raises on any other shape."""
    B, N, E = p.shape
    if a.shape == (E,) and (bias is None or bias.shape == (N, N)):
        return 1
    G = a.shape[0] if a.dim() == 2 else 0
    if G < 1 or a.shape != (G, E) or (bias is not None and bias.shape != (G, N, N)) or B % G:
        raise ValueError(
            f"{name}: a {tuple(a.shape)} and bias "
            f"{None if bias is None else tuple(bias.shape)} are neither ({E},) and ({N}, {N}) "
            f"nor G groups (G, {E}) and (G, {N}, {N}) with the batch {B} a multiple of G")
    return G


def gatv2_attention_fwd_plain(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
) -> torch.Tensor:
    """K1's function in plain tensor ops: the dense path of ``graph/ops.py``
    on float32 inputs, output in v's type. Grouped a and bias
    (``attention_groups``) run one group of B / G batch elements at a time."""
    B, N, E = p.shape
    G = attention_groups(p, a, bias, "gatv2_attention_fwd_plain")
    if G > 1 or a.dim() == 2:
        rows = B // G
        return torch.cat([gatv2_attention_fwd_plain(
            *(t[g * rows:(g + 1) * rows] for t in (p, q)), a[g],
            None if bias is None else bias[g], v[g * rows:(g + 1) * rows], alpha)
            for g in range(G)])
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, N * N * E))
    af = a.float()
    bf = None if bias is None else bias.float()
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        s = gatv2_scores_dense(p[sl].float(), q[sl].float(), af, alpha)
        out[sl] = gat_aggregate_dense(s, v[sl].float(), bf).to(v.dtype)
    return out


def _group_seed(seed: Seed, g: int, groups: int) -> Seed:
    """Group g's dropout seed: an int, or a one-element tensor, is every
    group's; a tensor of G values gives group g its own."""
    if isinstance(seed, torch.Tensor) and groups > 1 and seed.numel() == groups:
        return seed.reshape(-1)[g:g + 1]
    return seed


def _res_plain(p, q, a, bias, v, alpha, seed, rate, b0):
    """u, m, l of float32 inputs p, q, v (a batch slice starting at call
    index b0): masked softmax aggregate, differentiable (m is a constant)."""
    s = gatv2_scores_dense(p, q, a, alpha)
    if bias is not None:
        s = s + bias
    m = s.amax(dim=2).detach()
    ex = torch.exp(s - m[:, :, None])
    l = ex.sum(dim=2)
    w = ex / l[:, :, None]
    if rate > 0.0:
        keep = hash_keep_mask(seed, p.shape[0], p.shape[1], q.shape[1], rate,
                              batch_offset=b0, device=p.device)
        w = torch.where(keep, w / (1.0 - rate), 0.0)
    return torch.matmul(w, v), m, l


def gatv2_attention_res_plain(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
    seed: Seed = 0, rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1-res's function in plain tensor ops, float32 math: returns out (in
    v's type), u (B, N, D), m and l (B, N), all but out float32. Grouped a
    and bias (``attention_groups``), with one seed or G seeds, run one group
    of B / G batch elements at a time, its mask keyed by its seed and the
    batch index within the group."""
    B, N, E = p.shape
    D = v.shape[-1]
    G = attention_groups(p, a, bias, "gatv2_attention_res_plain")
    if a.dim() == 2:
        rows = B // G
        outs = [gatv2_attention_res_plain(
            *(t[g * rows:(g + 1) * rows] for t in (p, q)), a[g],
            None if bias is None else bias[g], v[g * rows:(g + 1) * rows], alpha,
            _group_seed(seed, g, G), rate) for g in range(G)]
        return tuple(torch.cat(ts) for ts in zip(*outs))
    f32 = dict(dtype=torch.float32, device=p.device)
    u, m, l = torch.empty((B, N, D), **f32), torch.empty((B, N), **f32), torch.empty((B, N), **f32)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, N * N * E))
    af = a.float()
    bf = None if bias is None else bias.float()
    with torch.no_grad():
        for b0 in range(0, B, chunk):
            sl = slice(b0, b0 + chunk)
            u[sl], m[sl], l[sl] = _res_plain(p[sl].float(), q[sl].float(), af, bf,
                                             v[sl].float(), alpha, seed, rate, b0)
    return torch.sigmoid(u).to(v.dtype), u, m, l


def gatv2_attention_bwd_plain(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, du: torch.Tensor,
    alpha: float, seed: Seed = 0, rate: float = 0.0,
) -> Tuple[torch.Tensor, ...]:
    """K2a-c's function: the gradients (dp, dq, da, dbias, dv) of the plain
    forward's u under the cotangent du, by autograd, in float32 (dbias is
    None without a bias). The kernels' dvec = du . u is what autograd
    derives through the row sum l. Grouped a and bias run a group at a time
    as ``gatv2_attention_res_plain``'s, with da (G, E) and dbias (G, N, N)
    each its group's."""
    B, N, E = p.shape
    G = attention_groups(p, a, bias, "gatv2_attention_bwd_plain")
    if a.dim() == 2:
        rows = B // G
        outs = [gatv2_attention_bwd_plain(
            *(t[g * rows:(g + 1) * rows] for t in (p, q)), a[g],
            None if bias is None else bias[g], v[g * rows:(g + 1) * rows],
            du[g * rows:(g + 1) * rows], alpha, _group_seed(seed, g, G), rate)
            for g in range(G)]
        dp, dq, da, dbias, dv = zip(*outs)
        return (torch.cat(dp), torch.cat(dq), torch.stack(da),
                None if bias is None else torch.stack(dbias), torch.cat(dv))
    dp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    dq, dv = torch.empty_like(dp), torch.empty(v.shape, dtype=torch.float32, device=p.device)
    af = a.detach().float().requires_grad_()
    bf = None if bias is None else bias.detach().float().requires_grad_()
    da = torch.zeros_like(af)
    dbias = None if bias is None else torch.zeros_like(bf)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, N * N * E))
    with torch.enable_grad():
        for b0 in range(0, B, chunk):
            sl = slice(b0, b0 + chunk)
            leaves = [t[sl].detach().float().requires_grad_() for t in (p, q, v)]
            u, _, _ = _res_plain(leaves[0], leaves[1], af, bf, leaves[2], alpha, seed, rate, b0)
            inputs = leaves + [af] + ([] if bf is None else [bf])
            grads = torch.autograd.grad(u, inputs, du[sl].float())
            dp[sl], dq[sl], dv[sl] = grads[:3]
            da += grads[3]
            if bf is not None:
                dbias += grads[4]
    return dp, dq, da, dbias, dv


# ---------------------------------------------------------------------------
# Wrappers: a CPU tensor takes the plain version, a CUDA tensor launches the
# kernel or raises. The backward wrappers take CUDA tensors only: on the CPU
# the autograd Function computes all three gradients in one plain call.
# ---------------------------------------------------------------------------


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("gat_fwd")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.gatv2_fwd_f32, lib.gatv2_fwd_bf16):
            fn.argtypes = [ptr] * 6 + [i32] * 6 + [f32, ptr]
            fn.restype = i32
        for fn in (lib.gatv2_fwd_res_f32, lib.gatv2_fwd_res_bf16):
            fn.argtypes = [ptr] * 10 + [i32] * 6 + [f32, ctypes.c_uint32, f32, ptr]
            fn.restype = i32
        lib.gatv2_fwd_tiled.argtypes = [ptr] * 9 + [i32] * 6 + [f32, ctypes.c_uint32, f32, ptr]
        lib.gatv2_fwd_tiled.restype = i32
        for fn in (lib.gatv2_fwd_merge_f32, lib.gatv2_fwd_merge_bf16):
            fn.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
            fn.restype = i32
        lib.gatv2_fwd_tiled_layout.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_long)]
        lib.gatv2_fwd_tiled_layout.restype = None
        lib.gatv2_fwd_tiled_occupancy.argtypes = [i32] * 3
        lib.gatv2_fwd_tiled_occupancy.restype = i32
        lib.gatv2_fwd_graph_smem_bytes.argtypes = [i32] * 4
        lib.gatv2_fwd_graph_smem_bytes.restype = ctypes.c_long
        lib.gatv2_fwd_graph_split.argtypes = []
        lib.gatv2_fwd_graph_split.restype = i32
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("gat_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [f32, ctypes.c_uint32, f32, ptr]
        for name, ptrs, ints in (("dp_da", 13, 8), ("dq_dv", 14, 9)):
            for dt in ("f32", "bf16"):
                fn = getattr(lib, f"gatv2_bwd_{name}_{dt}")
                fn.argtypes = [ptr] * ptrs + [i32] * ints + tail
                fn.restype = i32
        lib.gatv2_bwd_tiled_tile.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
        lib.gatv2_bwd_tiled_tile.restype = None
        lib.gatv2_bwd_tiled_smem_bytes.argtypes = [i32] * 5
        lib.gatv2_bwd_tiled_smem_bytes.restype = ctypes.c_long
        lib.gatv2_bwd_tiled_key_splits.argtypes = [i32, i32]
        lib.gatv2_bwd_tiled_key_splits.restype = i32
        lib.gatv2_bwd_tiled_occupancy.argtypes = [i32] * 8
        lib.gatv2_bwd_tiled_occupancy.restype = i32
        lib.gatv2_bwd_tiled_dbias_group.argtypes = [i32] * 5
        lib.gatv2_bwd_tiled_dbias_group.restype = i32
        for dt in ("f32", "bf16"):
            fn = getattr(lib, f"gatv2_bwd_dbias_{dt}")
            fn.argtypes = [ptr] * 11 + [i32] * 6 + tail
            fn.restype = i32
            fn = getattr(lib, f"gatv2_bwd_graph_{dt}")
            fn.argtypes = [ptr] * 15 + [i32] * 6 + tail
            fn.restype = i32
        lib.gatv2_bwd_smem_bytes.argtypes = [i32] * 4
        lib.gatv2_bwd_smem_bytes.restype = ctypes.c_long
        lib.gatv2_bwd_dbias_smem_bytes.argtypes = [i32] * 3
        lib.gatv2_bwd_dbias_smem_bytes.restype = ctypes.c_long
        lib.gatv2_bwd_graph_split.argtypes = []
        lib.gatv2_bwd_graph_split.restype = i32
        lib.gatv2_bwd_graph_row_groups.argtypes = [i32]
        lib.gatv2_bwd_graph_row_groups.restype = i32
        lib.gatv2_bwd_graph_dbias_group.argtypes = [i32, i32]
        lib.gatv2_bwd_graph_dbias_group.restype = i32
        lib.gatv2_bwd_graph_occupancy.argtypes = [i32] * 7
        lib.gatv2_bwd_graph_occupancy.restype = i32
        lib._typed = True
    return lib


def _streamed_lib() -> ctypes.CDLL:
    lib = _build.load("gat_streamed")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.gatv2_streamed_f32, lib.gatv2_streamed_bf16):
            fn.argtypes = [ptr] * 17 + [i32] * 7 + [f32, ctypes.c_uint32, f32, ptr]
            fn.restype = i32
        lib.gatv2_streamed_layout.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_long)]
        lib.gatv2_streamed_layout.restype = None
        lib.gatv2_streamed_occupancy.argtypes = [i32] * 7
        lib.gatv2_streamed_occupancy.restype = i32
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# K2ab, the whole-graph backward: what the plan needs of csrc/gat_bwd.cu's
# layout (GraphLayout's bytes, graph_row_groups' limit on N), the score's
# split that the CPU model of its arithmetic follows, and the plan that
# routes a call to it or to the tiled K2a and K2b.
# ---------------------------------------------------------------------------

GRAPH_SPLIT = 2                   # embedding splits of the whole-graph score passes (G_SPLIT)
GRAPH_RMAX = 8                    # most rows a thread owns in the contraction


def _up4(x: int) -> int:
    return -(-x // 4) * 4


def _stride4(x: int) -> int:
    """A row stride for float4 reads: an odd number of 16-byte units."""
    s = _up4(x)
    return s if (s // 4) % 2 else s + 4


def graph_row_groups(N: int) -> int:
    """Lanes that share one float4 group of the embedding in K2ab's
    contraction (each owns every RG-th row), 0 where N is too large."""
    return 8 if N <= 8 * GRAPH_RMAX else 16 if N <= 16 * GRAPH_RMAX else 0


def gat_bwd_smem_bytes(N: int, E: int, D: int) -> int:
    """Shared memory of one K2ab block: p and q [N4][EP], a [EP], v and du
    [N4][DP], m, l and dvec [N4], ds [N4][N4 + 1], wa [N4][NSW], float32,
    with N4 the graph padded to the 4 x 4 micro-tile."""
    n4, ep, dp = _up4(N), _stride4(E), _stride4(D)
    floats = 2 * n4 * ep + ep + 2 * n4 * dp + 3 * n4 + n4 * (n4 + 1) + n4 * _stride4(n4)
    return 4 * floats


@functools.lru_cache(maxsize=None)
def gat_bwd_plan(N: int, E: int, D: int, smem_limit: int = _SMEM_LIMIT) -> str:
    """Which backward runs a graph of N nodes at widths E (score) and D
    (values) on a card whose blocks may use ``smem_limit`` bytes of shared
    memory: "graph" (K2ab, one block holds a batch element's whole graph, and
    sums dbias too) where the graph fits a block, else "tiled" (K2a then K2b,
    K2b summing dbias too)."""
    if min(N, E, D) < 1:
        raise ValueError(f"gat_bwd_plan: empty graph or width (N {N}, E {E}, D {D})")
    if graph_row_groups(N) and gat_bwd_smem_bytes(N, E, D) <= smem_limit:
        return "graph"
    return "tiled"


def graph_block_batches(B: int, groups: int, group: int) -> List[Tuple[int, int]]:
    """The [first, end) batch elements of each K2ab block, in block order,
    at batch B in ``groups`` entity groups of B / G rows (``attention_groups``)
    and ``group`` elements a block (``dbias_groups`` of the group's rows
    with dbias, else 1): each entity's rows in runs of ``group``, the last
    one ragged, so no block straddles two entities and each entity's runs
    are those of an ungrouped launch at its rows (``csrc/gat_bwd.cu``,
    ``gatv2_bwd_graph_kernel``)."""
    if min(groups, group) < 1 or B < 0 or B % groups:
        raise ValueError(f"graph_block_batches: batch {B}, groups {groups}, group {group}")
    rows = B // groups
    return [(e * rows + k, e * rows + min(rows, k + group))
            for e in range(groups) for k in range(0, rows, group)]


def dbias_groups(B: int, sms: int) -> int:
    """Batch elements G of a K2ab block that sums dbias, on a card of
    ``sms`` multiprocessors: K2ab runs one block a multiprocessor (its
    shared memory and registers, PERF.md), so one group each, and at least
    two elements a group, so that the ceil(B / G) partials of (N, N) are
    never a (B, N, N) tensor; all of B where B is smaller. Groups are
    contiguous runs of G batch elements, the last one ragged."""
    if B < 1 or sms < 1:
        raise ValueError(f"dbias_groups: batch {B}, multiprocessors {sms}")
    return min(B, max(2, -(-B // sms)))


# ---------------------------------------------------------------------------
# The tiled K2a and K2b: what the plan needs of csrc/gat_bwd.cu's layout
# (their three tile shapes, TiledLayout's bytes, K2a's key splits), and the
# plan of a launch: tile, where the running sums live, slices of the
# streamed loop. The constants are read off bench_gat_bwd_torch.py --tiled
# (PERF.md, PR 10).
# ---------------------------------------------------------------------------

# (rows, keys) of the FAST, WIDE and CHUNKED tiles (TILE_*_RI, _KJ; CHUNK_*)
TILED_TILES = ((64, 64), (16, 32), (16, 32))
TILED_TILE_NAMES = ("fast", "wide", "chunked")
CHUNKED = 2                       # the tile that streams E and D in chunks
TILED_CHUNK = 64                  # floats of E or D a CHUNKED block stages at once (TILE_CHUNK)
# running sums in shared memory or not, each kernel's preference first: K2a
# is faster with them there, K2b without (its block then fits twice on a
# multiprocessor); the first that fits a block is taken, FAST tile first
TILED_CHOICES = {"k2a": (True, False), "k2b": (False, True)}
TILED_FILL = 16                   # blocks a multiprocessor the slices aim for
TILED_MIN_TILES = 4               # fewest streamed tiles a slice walks
TILED_MAX_SLICES = 64


class TiledKernelPlan(NamedTuple):
    """One launch of the tiled K2a ("k2a") or K2b ("k2b")."""

    kernel: str
    tile: int                     # index into TILED_TILES (TILED_TILE_NAMES)
    rows: int                     # score tile: rows x keys, one 4 x 4 micro-tile a thread
    keys: int
    threads: int
    acc_smem: bool                # running sums in shared memory, else in the partial itself
    own_tiles: int                # tiles a block owns: row tiles (K2a), key tiles (K2b)
    stream_tiles: int             # tiles its loop walks: key tiles (K2a), row tiles (K2b)
    slices: int                   # the loop cut into this many blocks
    blocks: int                   # slices x batch groups x own_tiles
    smem_bytes: int
    partial_bytes: int            # float32 partials, (slices, B, N, E) or (slices, B, N, E + D)
    key_splits: int               # lanes sharing one item of K2a's contraction (K2b: 1)
    da_rows: int                  # K2a's float32 rows of E of da partial sums (K2b: 0)
    dbias: bool                   # K2b sums K2c's dbias in the same pass (K2a: never)
    group: int                    # batch elements a block takes (1 without dbias)
    dbias_bytes: int              # its float32 (batch groups, N, N) partials; 0 without
    entities: int = 1             # groups of a and bias (the entity axis), B / entities rows each


def first_design_smem_bytes(E: int, D: int) -> int:
    """Shared memory of the larger block of the first tiled K2a and K2b (16
    x 32 tiles, full widths in shared memory at odd strides, PRs 1-2): the
    FAST and WIDE tiles run within the widths it accepted, the CHUNKED tile
    beyond them."""
    odd = lambda x: x | 1  # noqa: E731
    tile = 48 * odd(E) + E + 48 * odd(D) + 48
    return 4 * max(tile + 512 + 20 * E, tile + 1024 + 32 * E + 32 * D)


def tiled_smem_bytes(kernel: str, rows: int, keys: int, E: int, D: int,
                     acc_smem: bool) -> int:
    """Shared memory of one FAST or WIDE block (``dp_da_floats`` /
    ``dq_dv_floats``)."""
    ep, dp, ea, da = _stride4(E), _stride4(D), _up4(E), _up4(D)
    if kernel == "k2b":
        f = (ep + keys * (ep + dp) + rows * (ep + dp + 3) + 2 * rows * keys
             + (keys * (ea + da) if acc_smem else 0))
    elif kernel == "k2a":
        f = (ep + rows * (ep + dp + 3) + keys * (ep + dp) + keys * _stride4(rows)
             + rows // 4 * ea + (rows * ea if acc_smem else 0))
    else:
        raise ValueError(f"tiled_smem_bytes: kernel {kernel!r} is neither 'k2a' nor 'k2b'")
    return 4 * f


def chunked_smem_bytes(kernel: str) -> int:
    """Shared memory of one CHUNKED block (``chunked_floats``), the same at
    every width: a chunk of the row tile's p or du, of the key tile's q or v
    and of a, the row tile's m, l and dvec, then K2b's ds and wa or K2a's ds
    by key."""
    rows, keys = TILED_TILES[CHUNKED]
    cp = _stride4(TILED_CHUNK)
    tail = 2 * rows * keys if kernel == "k2b" else keys * _stride4(rows)
    return 4 * ((rows + keys + 1) * cp + 3 * rows + tail)


def key_splits(items: int, threads: int) -> int:
    """Lanes (1, 2 or 4) that share one item of K2a's contraction (row
    groups x float4 groups of E), each taking every ks-th key, their sums
    added by a butterfly: the split whose items x splits fill the block's
    threads the best round for round, the fewest on a tie."""
    best, best_eff = 1, 0.0
    for ks in (1, 2, 4):
        num = items * ks
        eff = num / (-(-num // threads) * threads)
        if eff > best_eff:
            best, best_eff = ks, eff
    return best


def slice_bounds(tiles: int, slices: int) -> List[Tuple[int, int]]:
    """The [begin, end) tiles of each slice of a loop over ``tiles``
    (``slice_begin`` in the kernels): every tile once, sizes differing by at
    most one."""
    if not 1 <= slices <= tiles:
        raise ValueError(f"slice_bounds: {slices} slices of {tiles} tiles")
    return [(s * tiles // slices, (s + 1) * tiles // slices) for s in range(slices)]


def tiled_slices(own_blocks: int, stream_tiles: int, sms: int) -> int:
    """Slices of the streamed loop: the fewest that give ``TILED_FILL``
    blocks a multiprocessor, at most ``TILED_MAX_SLICES`` and so many that
    a slice walks ``TILED_MIN_TILES`` tiles (its partial's write and read,
    once a slice, stay small beside its work), at least one."""
    most = min(TILED_MAX_SLICES, stream_tiles // TILED_MIN_TILES)
    return max(1, min(most, -(-TILED_FILL * sms // own_blocks)))


def tiled_dbias_groups(B: int, N: int, tile: int, sms: int,
                       rows_per_group: Optional[int] = None) -> int:
    """Batch elements G a block of the tiled K2b takes when it sums dbias
    (K2c's function) in its own pass, at batch B, N nodes and tile shape
    ``tile`` (an index into ``TILED_TILES``) on a card of ``sms``
    multiprocessors: the most such that ceil(B / G) groups x key tiles x the
    most slices ``tiled_slices`` allows still give ``TILED_FILL`` blocks a
    multiprocessor, so the fold never costs the card its fill; 1 where even
    groups of one element fall short, all of B where one group reaches it.
    G is 1 at B 1 and never falls as B grows; each group writes one (N, N)
    float32 partial, ceil(B / G) in all, summed in order by the caller.
    With the entity axis B is the whole grouped batch and G is capped at an
    entity's ``rows_per_group`` rows, so that no group straddles two
    entities (their runs: ``graph_block_batches``). ``csrc/gat_bwd.cu``
    (``tiled_dbias_group``) holds the same rule."""
    rows_per_group = B if rows_per_group is None else rows_per_group
    if (min(B, N, sms, rows_per_group) < 1 or B % rows_per_group
            or not 0 <= tile < len(TILED_TILES)):
        raise ValueError(f"tiled_dbias_groups: batch {B}, N {N}, tile {tile}, "
                         f"multiprocessors {sms}, rows a group {rows_per_group}")
    rows, keys = TILED_TILES[tile]
    own, stream = -(-N // keys), -(-N // rows)
    most = max(1, min(TILED_MAX_SLICES, stream // TILED_MIN_TILES))
    need = -(-TILED_FILL * sms // (most * own))       # groups the fill needs
    return min(rows_per_group, B if need <= 1 else max(1, -(-B // (need - 1)) - 1))


def _tiled_tile(kernel: str, E: int, D: int, smem_limit: int) -> Tuple[int, bool, int]:
    """(tile, running sums in shared memory, bytes) of K2a or K2b at widths
    E, D: the first FAST or WIDE choice that fits within the widths the
    first design accepted, else CHUNKED."""
    if first_design_smem_bytes(E, D) <= smem_limit:
        for tile, (rows, keys) in enumerate(TILED_TILES[:CHUNKED]):
            for acc in TILED_CHOICES[kernel]:
                nbytes = tiled_smem_bytes(kernel, rows, keys, E, D, acc)
                if nbytes <= smem_limit:
                    return tile, acc, nbytes
    nbytes = chunked_smem_bytes(kernel)
    if nbytes > smem_limit:
        raise ValueError(f"gatv2 tiled backward: a CHUNKED block of {kernel} needs {nbytes} "
                         f"bytes of shared memory, the card {smem_limit}")
    return CHUNKED, False, nbytes


@functools.lru_cache(maxsize=None)
def gat_tiled_bwd_plan(B: int, N: int, E: int, D: int, sms: int,
                       smem_limit: int = _SMEM_LIMIT, dbias: bool = False,
                       groups: int = 1) -> Mapping[str, TiledKernelPlan]:
    """The launches of the tiled K2a and K2b ({"k2a": ..., "k2b": ...}) at
    batch B, N nodes, widths E and D on a card of ``sms`` multiprocessors
    whose blocks may use ``smem_limit`` bytes of shared memory, K2b summing
    dbias too with ``dbias``. Within the widths the first design accepted
    (``first_design_smem_bytes``: the feature layer up to window 235, the
    temporal layer at D 38 up to E 665) each takes the first FAST or WIDE
    tile and place of its running sums (``TILED_CHOICES``) that fits, as
    before; beyond them, or where none fits, the CHUNKED tile, which takes
    every width. Its streamed loop is cut into ``tiled_slices`` blocks. K2b
    with dbias takes its batch in
    groups of ``tiled_dbias_groups`` elements, a block each (slices x
    groups x key tiles), and writes one (N, N) float32 partial a group;
    dbias costs its shared memory nothing. ``groups``: the entity axis, B
    in that many entities of B / groups rows, which K2b's batch groups
    never straddle (each entity's rows in runs of the group, the grouped
    batch's ``tiled_dbias_groups`` capped at its rows); the slices follow
    from the grouped launch's blocks. Raises on empty or bad input."""
    if min(B, N, E, D, sms, groups) < 1 or B % groups:
        raise ValueError(f"gat_tiled_bwd_plan: empty or bad input (B {B}, N {N}, E {E}, "
                         f"D {D}, multiprocessors {sms}, entities {groups})")
    rows_per_group = B // groups
    plans = {}
    for kernel in ("k2a", "k2b"):
        tile, acc, nbytes = _tiled_tile(kernel, E, D, smem_limit)
        rows, keys = TILED_TILES[tile]
        row_tiles, key_tiles = -(-N // rows), -(-N // keys)
        own, stream = (row_tiles, key_tiles) if kernel == "k2a" else (key_tiles, row_tiles)
        sums = dbias and kernel == "k2b"
        group = tiled_dbias_groups(B, N, tile, sms, rows_per_group) if sums else 1
        runs = groups * -(-rows_per_group // group)       # batch groups, by entity
        slices = tiled_slices(runs * own, stream, sms)
        threads = rows * keys // 16
        width = E if kernel == "k2a" else E + D
        splits = 1
        if kernel == "k2a" and tile != CHUNKED:
            splits = key_splits(rows // 4 * -(-E // 4), threads)
        blocks = slices * runs * own
        plans[kernel] = TiledKernelPlan(
            kernel=kernel, tile=tile, rows=rows, keys=keys, threads=threads, acc_smem=acc,
            own_tiles=own, stream_tiles=stream, slices=slices, blocks=blocks,
            smem_bytes=nbytes, partial_bytes=4 * slices * B * N * width, key_splits=splits,
            da_rows=0 if kernel == "k2b" else blocks * (rows // 4 if tile == CHUNKED else 1),
            dbias=sums, group=group, dbias_bytes=4 * runs * N * N if sums else 0,
            entities=groups)
    return types.MappingProxyType(plans)      # cached: read-only to every caller


# ---------------------------------------------------------------------------
# The streamed backward (csrc/gat_streamed.cu): K2a and K2b, with K2c's
# dbias, as two passes where the tiled plan would run the CHUNKED tile on a
# small graph (a wide feature layer): a score pass over (batch element, row
# tile) blocks writing ds and wa (B, N, N), then a contraction pass over
# (batch element, columns of E or of D) blocks. What the plan needs of the
# source's layout, and the route of a call.
# ---------------------------------------------------------------------------

STREAMED_CHUNK = 64               # floats of E or D a score block stages at once (SC)
STREAMED_RING = 2                 # its staging buffers (RING)
STREAMED_ROWS_MAX = 16            # the score pass's largest row tile (ROWS_MAX)
STREAMED_STAGE_COST = 0.5         # a staged row's cost in pairs scored, for the row tile
STREAMED_MR2_ROWS = 8             # row tiles from which a score thread holds two rows
STREAMED_COLS = 128               # columns of E or D a contraction block owns, a thread each (CW)
STREAMED_NMAX = 64                # most keys a contraction thread holds in registers (NMAX)
STREAMED_KEY_STEP = 8             # they come in steps of 8 (KEY_STEP)


class StreamedPlan(NamedTuple):
    """One launch of the streamed backward: its score pass, then its
    contraction pass."""

    rows: int                     # the score pass's row tile
    rows_per_thread: int          # its rows a thread holds against one key (1 or 2)
    score_threads: int            # one a key and rows_per_thread rows, up to whole warps
    score_blocks: int             # B x ceil(N / rows)
    score_smem_bytes: int
    chunk: int                    # floats of E or D staged at once, through STREAMED_RING buffers
    key_regs: int                 # keys a contraction thread holds: N up to a multiple of 8
    cols: int                     # columns of a contraction block
    e_blocks: int                 # B x ceil(E / cols)
    d_blocks: int                 # B x ceil(D / cols)
    dbias_blocks: int             # ceil(N^2 / cols) with dbias, else 0
    contract_blocks: int
    contract_smem_bytes: int
    scratch_bytes: int            # ds and wa (B, N, N) and da rows (B, E), float32
    dbias: bool


def streamed_key_regs(N: int) -> int:
    """Keys a contraction thread holds in registers: N up to a multiple of
    ``STREAMED_KEY_STEP``, 0 above ``STREAMED_NMAX`` (``key_regs``)."""
    if not 1 <= N <= STREAMED_NMAX:
        return 0
    return -(-N // STREAMED_KEY_STEP) * STREAMED_KEY_STEP


def streamed_score_smem_bytes(N: int, rows: int) -> int:
    """Shared memory of one score block (``score_floats``): STREAMED_RING
    buffers of a chunk of the row tile's p or du [rows][SCP], of the keys' q
    or v [N][SCP] and of a [SCP], then m, l and dvec [rows]."""
    return 4 * (STREAMED_RING * (rows + N + 1) * _stride4(STREAMED_CHUNK) + 3 * rows)


def streamed_contract_smem_bytes(N: int) -> int:
    """Shared memory of one contraction block (``contract_floats``): ds or
    wa and lo ds [N][key_regs], the row sums of ds [N] and its column sums
    [key_regs], the block's columns of p or du [N][STREAMED_COLS]."""
    nr = streamed_key_regs(N)
    return 4 * (2 * N * nr + N + nr + N * STREAMED_COLS)


@functools.lru_cache(maxsize=None)
def streamed_nmax(smem_limit: int = _SMEM_LIMIT) -> int:
    """The largest graph the streamed backward takes: at most
    ``STREAMED_NMAX`` nodes (a contraction thread holds a key column in
    registers), and its score block at the largest row tile, staged through
    its ring, and its contraction block both within ``smem_limit`` bytes of
    shared memory; 0 where none fits."""
    for N in range(STREAMED_NMAX, 0, -1):
        if max(streamed_score_smem_bytes(N, STREAMED_ROWS_MAX),
               streamed_contract_smem_bytes(N)) <= smem_limit:
            return N
    return 0


def streamed_rows(B: int, N: int, sms: int) -> int:
    """The score pass's row tile: of the even tiles from 2 to
    ``STREAMED_ROWS_MAX`` rows (at most N up to even), the one that leaves
    the busiest of ``sms`` multiprocessors the least work, ceil(B x ceil(N /
    rows) / sms) blocks of rows x N pairs to score and rows + N rows to
    stage, a staged row counted as ``STREAMED_STAGE_COST`` pairs (a chunk's
    16 copies against a pair's 64 terms); on a tie the fewest row tiles. At
    batch 64, N 38 on 132 multiprocessors: 10 rows, 256 blocks, two a
    multiprocessor (8 rows: 320 blocks, three on some)."""
    if min(B, N, sms) < 1:
        raise ValueError(f"streamed_rows: batch {B}, N {N}, multiprocessors {sms}")
    tiles = lambda r: -(-N // r)  # noqa: E731
    return min(range(2, min(STREAMED_ROWS_MAX, max(2, N + N % 2)) + 1, 2),
               key=lambda r: (-(-B * tiles(r) // sms) * (r * N + STREAMED_STAGE_COST * (r + N)),
                              tiles(r)))


def streamed_rows_per_thread(rows: int) -> int:
    """Rows of the score pass's row tile a thread holds against its one
    key: 2 (the key's staged q and v read once for both) where the tile has
    ``STREAMED_MR2_ROWS`` rows or more, else 1, so that a small batch keeps
    a thread a pair."""
    return 2 if rows >= STREAMED_MR2_ROWS else 1


@functools.lru_cache(maxsize=None)
def gat_bwd_route(N: int, E: int, D: int, smem_limit: int = _SMEM_LIMIT) -> str:
    """The backward a graph of N nodes at widths E and D takes: "graph"
    (K2ab) or "tiled" (K2a then K2b) as ``gat_bwd_plan`` names them, except
    that where the tiled plan would run the CHUNKED tile for both kernels
    and N is at most ``streamed_nmax``, "streamed" (the streamed
    backward)."""
    variant = gat_bwd_plan(N, E, D, smem_limit)
    if (variant == "tiled" and N <= streamed_nmax(smem_limit)
            and all(_tiled_tile(k, E, D, smem_limit)[0] == CHUNKED for k in ("k2a", "k2b"))):
        return "streamed"
    return variant


@functools.lru_cache(maxsize=None)
def gat_streamed_bwd_plan(B: int, N: int, E: int, D: int, sms: int,
                          smem_limit: int = _SMEM_LIMIT, dbias: bool = False) -> StreamedPlan:
    """The launch of the streamed backward at batch B, N nodes, widths E and
    D on a card of ``sms`` multiprocessors whose blocks may use
    ``smem_limit`` bytes of shared memory, summing dbias with ``dbias``.
    Raises on empty or bad input and above ``streamed_nmax``."""
    if min(B, N, E, D, sms) < 1:
        raise ValueError(f"gat_streamed_bwd_plan: empty or bad input (B {B}, N {N}, E {E}, "
                         f"D {D}, multiprocessors {sms})")
    if N > streamed_nmax(smem_limit):
        raise ValueError(f"gat_streamed_bwd_plan: N {N} is above the streamed backward's "
                         f"{streamed_nmax(smem_limit)} nodes")
    rows = streamed_rows(B, N, sms)
    mr = streamed_rows_per_thread(rows)
    cols = STREAMED_COLS
    e_blocks, d_blocks = B * -(-E // cols), B * -(-D // cols)
    dbias_blocks = -(-N * N // cols) if dbias else 0
    return StreamedPlan(
        rows=rows, rows_per_thread=mr, score_threads=-(-rows // mr * N // 32) * 32,
        score_blocks=B * -(-N // rows), score_smem_bytes=streamed_score_smem_bytes(N, rows),
        chunk=STREAMED_CHUNK, key_regs=streamed_key_regs(N), cols=cols, e_blocks=e_blocks,
        d_blocks=d_blocks, dbias_blocks=dbias_blocks,
        contract_blocks=e_blocks + d_blocks + dbias_blocks,
        contract_smem_bytes=streamed_contract_smem_bytes(N),
        scratch_bytes=4 * (2 * B * N * N + B * E), dbias=dbias)


# ---------------------------------------------------------------------------
# The forward's variants: what the plan needs of csrc/gat_fwd.cu's whole-graph
# layout (FwdLayout's bytes), its split of a graph's rows over blocks, and
# the plan that routes a call to it or to the tiled kernel.
# ---------------------------------------------------------------------------

def gat_fwd_smem_bytes(N: int, E: int, D: int, row_blocks: int = 1) -> int:
    """Shared memory of one block of the whole-graph forward: its rows of p
    [RB][EP], q [N4][EP], a [EP], v [N4][DP], its scores [RB][NSW], m and l
    [RB], float32, with N4 the graph and RB a block's share of its rows,
    each padded to the 4 x 4 micro-tile."""
    n4, rb = _up4(N), _up4(-(-N // row_blocks))
    ep, dp = _stride4(E), _stride4(D)
    return 4 * (rb * ep + n4 * ep + ep + n4 * dp + rb * _stride4(n4) + 2 * rb)


def fwd_row_blocks(N: int, E: int, D: int, smem_limit: int = _SMEM_LIMIT) -> int:
    """Blocks that share one graph's rows in the whole-graph forward on a
    card whose blocks may use ``smem_limit`` bytes of shared memory: 1 where
    the whole graph fits a block, 2 where half its rows do (each block then
    holds q, v and its half of p and of the scores), else 0. One block is
    preferred: at the temporal layer it was faster than two that share a
    multiprocessor (PERF.md)."""
    for row_blocks in (1, 2):
        if gat_fwd_smem_bytes(N, E, D, row_blocks) <= smem_limit:
            return row_blocks
    return 0


@functools.lru_cache(maxsize=None)
def gat_fwd_plan(N: int, E: int, D: int, smem_limit: int = _SMEM_LIMIT) -> str:
    """Which forward runs a graph of N nodes at widths E (score) and D
    (values) on a card whose blocks may use ``smem_limit`` bytes of shared
    memory: "graph" (K1 and K1-res's whole-graph kernel, a batch element's
    graph, or half its rows, on chip; ``fwd_row_blocks``) where that fits a
    block, else "tiled" (64 x 64 score tiles streaming the keys, any width;
    ``gat_tiled_fwd_plan``)."""
    if min(N, E, D) < 1:
        raise ValueError(f"gat_fwd_plan: empty graph or width (N {N}, E {E}, D {D})")
    return "graph" if fwd_row_blocks(N, E, D, smem_limit) else "tiled"


@functools.lru_cache(maxsize=None)
def _check_fwd_layout(N: int, E: int, D: int) -> int:
    """Refuse a shape the whole-graph forward cannot hold, and a built kernel
    whose shared memory or score split this module no longer mirrors (once
    per shape); returns the row blocks of a launch."""
    if gat_fwd_plan(N, E, D) != "graph":
        raise ValueError(f"gatv2 forward: a graph of {N} nodes at widths E {E}, D {D} "
                         "does not fit a block; gat_fwd_plan routes it to the tiled kernel")
    row_blocks = fwd_row_blocks(N, E, D)
    lib = _fwd_lib()
    built = (lib.gatv2_fwd_graph_smem_bytes(N, E, D, row_blocks), lib.gatv2_fwd_graph_split())
    if built != (gat_fwd_smem_bytes(N, E, D, row_blocks), GRAPH_SPLIT):
        raise RuntimeError(f"gatv2 forward: the built kernel's (shared memory, split) {built} "
                           "differ from this module's")
    return row_blocks


# ---------------------------------------------------------------------------
# The tiled forward: what the plan needs of csrc/gat_fwd.cu's TiledFwdLayout
# (the tile, the chunks of E and D, a block's bytes) and the plan of a
# launch: its slices of the key loop, the partials the merge combines.
# ---------------------------------------------------------------------------

TILED_FWD_TILE = (64, 64)         # rows, keys of a score tile (FWD_RI, FWD_KJ)
TILED_FWD_EC_MAX = 128            # most embedding columns staged at once (FWD_EC_MAX)
TILED_FWD_DC = 64                 # columns of D an aggregate chunk (FWD_DC)
TILED_FWD_WS = 80                 # stride of a block's weights (FWD_WS)


class TiledFwdPlan(NamedTuple):
    """One launch of the tiled K1 or K1-res and its merge."""

    rows: int                     # score tile: rows x keys, one 4 x 4 micro-tile a thread
    keys: int
    threads: int
    e_chunk: int                  # embedding columns staged at once, a multiple of 4
    e_chunks: int
    d_chunks: int                 # 64-column chunks of D the aggregate walks
    tiles: int                    # row tiles, and key tiles
    slices: int                   # the key loop cut into this many blocks
    blocks: int                   # slices x B x tiles
    smem_bytes: int
    partial_bytes: int            # float32 partials: aggregate (S, B, N, D), m and l (S, B, N)


def tiled_fwd_chunk(E: int) -> int:
    """Embedding columns a tiled forward block stages at once: E (up to a
    multiple of 4) up to ``TILED_FWD_EC_MAX``, else E split into the fewest
    even chunks of at most that, each a multiple of 4, so the chunk
    boundaries fall on float4 groups."""
    n = -(-E // TILED_FWD_EC_MAX)
    return _up4(-(-E // n))


def tiled_fwd_smem_bytes(E: int) -> int:
    """Shared memory of one tiled forward block (``TiledFwdLayout``): p and
    q [64][ECP], a [ECP], v [64][64], the weights [64][80], float32."""
    rows, keys = TILED_FWD_TILE
    ecp = _stride4(tiled_fwd_chunk(E))
    return 4 * ((rows + keys + 1) * ecp + keys * TILED_FWD_DC + rows * TILED_FWD_WS)


@functools.lru_cache(maxsize=None)
def gat_tiled_fwd_plan(B: int, N: int, E: int, D: int, sms: int,
                       smem_limit: int = _SMEM_LIMIT) -> TiledFwdPlan:
    """The launch of the tiled K1 or K1-res at batch B, N nodes, widths E
    and D on a card of ``sms`` multiprocessors whose blocks may use
    ``smem_limit`` bytes of shared memory: 64 x 64 score tiles, E staged in
    ``tiled_fwd_chunk`` columns and D aggregated by 64-column chunks (any
    width: a block holds at most 105 KB), the key loop cut into
    ``tiled_slices`` blocks of its own so that batch 1 fills the card. Each
    slice writes float32 partials (aggregate, m, l) of its rows, linear in
    N, that ``gatv2_fwd_merge`` combines. Raises on empty or bad input."""
    if min(B, N, E, D, sms) < 1:
        raise ValueError(f"gat_tiled_fwd_plan: empty or bad input (B {B}, N {N}, E {E}, "
                         f"D {D}, multiprocessors {sms})")
    nbytes = tiled_fwd_smem_bytes(E)
    if nbytes > smem_limit:
        raise ValueError(f"gat_tiled_fwd_plan: a block needs {nbytes} bytes of shared memory, "
                         f"the card {smem_limit}")
    rows, keys = TILED_FWD_TILE
    tiles = -(-N // rows)
    slices = tiled_slices(B * tiles, tiles, sms)
    ec = tiled_fwd_chunk(E)
    return TiledFwdPlan(rows=rows, keys=keys, threads=rows * keys // 16, e_chunk=ec,
                        e_chunks=-(-E // ec), d_chunks=-(-D // TILED_FWD_DC), tiles=tiles,
                        slices=slices, blocks=slices * B * tiles, smem_bytes=nbytes,
                        partial_bytes=4 * slices * B * N * (D + 2))


@functools.lru_cache(maxsize=None)
def _tiled_fwd_plan(B: int, N: int, E: int, D: int, sms: int) -> TiledFwdPlan:
    """``gat_tiled_fwd_plan`` for a launch, refused where the built
    library's tile, chunks or shared memory differ from the plan's (once per
    shape and card)."""
    plan = gat_tiled_fwd_plan(B, N, E, D, sms)
    out = (ctypes.c_long * 6)()
    _fwd_lib().gatv2_fwd_tiled_layout(E, D, out)
    want = (plan.rows, plan.keys, plan.threads, plan.e_chunk, TILED_FWD_DC, plan.smem_bytes)
    if tuple(out) != want:
        raise RuntimeError(f"gatv2 tiled forward: the built kernel's (rows, keys, threads, "
                           f"chunks, shared memory) {tuple(out)} differ from the plan's {want}")
    return plan


def gatv2_fwd_merge_plain(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                          dtype: torch.dtype = torch.float32
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The merge's function in plain tensor ops: (out in ``dtype``, u, m, l)
    from the slices' float32 partials acc (S, B, N, D), m and l (S, B, N),
    the slices in order: m = max_s m_s, l = sum_s l_s e^(m_s - m), u = sum_s
    acc_s e^(m_s - m) / l."""
    mx = m.amax(dim=0)
    lsum = torch.zeros_like(mx)
    usum = torch.zeros(acc.shape[1:], dtype=torch.float32, device=acc.device)
    for s in range(acc.shape[0]):
        c = torch.exp(m[s] - mx)
        lsum = lsum + l[s] * c
        usum = usum + acc[s] * c[..., None]
    u = usum / lsum[..., None]
    return torch.sigmoid(u).to(dtype), u, mx, lsum


def gatv2_fwd_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                    dtype: torch.dtype = torch.float32, residuals: bool = True
                    ) -> Tuple[torch.Tensor, ...]:
    """The tiled forward's merge: (out (B, N, D) in ``dtype``, u, m, l) from
    the slices' float32 partials acc (S, B, N, D), m and l (S, B, N), as
    ``gatv2_fwd_merge_plain`` computes them; u, m and l are None without
    ``residuals`` (K1). A CPU tensor takes the plain version, a CUDA tensor
    launches the merge kernel or raises."""
    if acc.device.type == "cpu":
        out = gatv2_fwd_merge_plain(acc, m, l, dtype)
        return out if residuals else (out[0], None, None, None)
    S, B, N, D = acc.shape
    if m.shape != (S, B, N) or l.shape != (S, B, N) or any(
            t.dtype != torch.float32 or not t.is_contiguous() for t in (acc, m, l)):
        raise ValueError(f"gatv2_fwd_merge: partials acc {tuple(acc.shape)}, m "
                         f"{tuple(m.shape)}, l {tuple(l.shape)} must be contiguous float32 "
                         "(S, B, N, D) and (S, B, N)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gatv2_fwd_merge: output type {dtype}")
    f32 = dict(dtype=torch.float32, device=acc.device)
    out = torch.empty((B, N, D), dtype=dtype, device=acc.device)
    u, mo, lo = ((torch.empty((B, N, D), **f32), torch.empty((B, N), **f32),
                  torch.empty((B, N), **f32)) if residuals else (None, None, None))
    lib = _fwd_lib()
    fn = lib.gatv2_fwd_merge_f32 if dtype == torch.float32 else lib.gatv2_fwd_merge_bf16
    with torch.cuda.device(acc.device):
        err = fn(_ptr(acc), _ptr(m), _ptr(l), _ptr(out), _ptr(u), _ptr(mo), _ptr(lo),
                 B, N, D, S, _stream(acc.device))
    _raise_on(err, "gatv2_fwd_merge")
    gatv2_fwd_merge.launches += 1
    return out, u, mo, lo


gatv2_fwd_merge.launches = 0


def _fwd_variant(N: int, E: int, D: int, variant: Optional[str]) -> Tuple[str, int]:
    """(variant, row blocks) of a forward launch: the planned variant, or
    the one the caller forces; the tiled kernel takes every width."""
    variant = variant or gat_fwd_plan(N, E, D)
    if variant == "graph":
        return variant, _check_fwd_layout(N, E, D)
    if variant != "tiled":
        raise ValueError(f"gatv2 forward: variant {variant!r} is neither 'graph' nor 'tiled'")
    return variant, 0


def _fwd_tiled(p, q, a, bias, v, alpha, seed, rate, residuals: bool, groups: int = 1):
    """The tiled K1 (or K1-res with ``residuals``) on CUDA tensors: the
    kernel writes the slices' partials, ``gatv2_fwd_merge`` combines them;
    returns (out, u, m, l) and the plan. The kernel reads float32 p, q, a,
    v: bfloat16 ones are widened here (exactly). ``groups``: the entity
    axis, a and bias grouped as ``attention_groups`` says, one seed a
    group."""
    B, N, E = p.shape
    D = v.shape[-1]
    plan = _tiled_fwd_plan(B, N, E, D, _build.sm_count(p.device))
    pf, qf, af, vf = (t.detach().to(torch.float32).contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.detach().to(torch.float32).contiguous()
    seed_t, thresh, scale = _drop_args(seed, rate, p.device, groups)
    S = plan.slices
    part = torch.empty(S * B * N * (D + 2), dtype=torch.float32, device=p.device)
    acc = part[:S * B * N * D].view(S, B, N, D)
    m, l = part[S * B * N * D:].view(2, S, B, N)
    with torch.cuda.device(p.device):
        err = _fwd_lib().gatv2_fwd_tiled(
            _ptr(pf), _ptr(qf), _ptr(af), _ptr(bias_c), _ptr(vf), _ptr(seed_t), _ptr(acc),
            _ptr(m), _ptr(l), B, N, E, D, S, B // groups, float(alpha), thresh, scale,
            _stream(p.device))
    _raise_on(err, "gatv2_fwd_tiled")
    return gatv2_fwd_merge(acc, m, l, v.dtype, residuals), plan


def _count_fwd(fn, variant: str, row_blocks: int, plan: Optional[TiledFwdPlan] = None,
               groups: int = 1) -> None:
    fn.launches += 1
    fn.launches_by_variant[variant] += 1
    fn.last_launch = {"variant": variant, "row_blocks": row_blocks,
                      "plan": None if plan is None else plan._asdict(), "groups": groups}


def _check(name: str, p, q, a, bias, v, grouped: bool = False) -> int:
    """Device, type and shape checks of a CUDA launch; returns the groups of
    a and bias (``attention_groups``), which only a ``grouped`` call (every
    kernel but K2c) may have more than one of."""
    if p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {p.device}")
    B, N, E = p.shape
    if q.shape != p.shape or v.shape[:2] != (B, N) or a.shape[-1:] != (E,):
        raise ValueError(
            f"{name}: shapes p {tuple(p.shape)} q {tuple(q.shape)} "
            f"a {tuple(a.shape)} v {tuple(v.shape)} do not agree")
    if not grouped and (a.dim() != 1 or (bias is not None and bias.shape != (N, N))):
        raise ValueError(f"{name}: a {tuple(a.shape)} and bias "
                         f"{None if bias is None else tuple(bias.shape)} are not ({E},) and "
                         f"({N}, {N}): K2c takes no entity axis")
    groups = attention_groups(p, a, bias, name)
    if p.dtype not in (torch.float32, torch.bfloat16) or any(
        t.dtype != p.dtype for t in (q, a, v)
    ):
        raise TypeError(f"{name}: p, q, a and v must all be float32 or all bfloat16")
    tensors = (q, a, v) + (() if bias is None else (bias,))
    if any(t.device != p.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if E == 0:
        raise ValueError(f"{name}: empty embedding")
    return groups


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _drop_args(seed: Seed, rate: float, device, groups: int = 1):
    """(seed tensor or None, keep threshold, scale) of a launch: one int64
    seed, or one a group of a grouped launch (an int, or one value, is
    every group's)."""
    if rate <= 0.0:
        return None, 0, 1.0
    if not isinstance(seed, torch.Tensor):
        # a fill kernel carries the value: no host-to-device copy
        seed = torch.full((groups,), seed_int(seed), dtype=torch.int64, device=device)
    elif seed.dtype != torch.int64 or seed.numel() not in (1, groups) or seed.device != device:
        raise ValueError(f"the dropout seed must be one int64 value, or {groups} (one a "
                         "group), on the device of the inputs")
    elif groups > 1:
        seed = seed.reshape(-1).expand(groups).contiguous()
    return seed, keep_threshold(rate), 1.0 / (1.0 - rate)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def gatv2_attention_fwd(
    p: torch.Tensor,                 # (B, N, E) query-side projection
    q: torch.Tensor,                 # (B, N, E) key-side projection + lin bias
    a: torch.Tensor,                 # (E,) attention vector; or (G, E)
    bias: Optional[torch.Tensor],    # (N, N) score bias, or None; or (G, N, N)
    v: torch.Tensor,                 # (B, N, D) node values
    alpha: float,                    # leaky-relu negative slope
    variant: Optional[str] = None,   # "graph" or "tiled"; None: gat_fwd_plan's
) -> torch.Tensor:
    """Fused GATv2 attention forward (K1), (B, N, D) in v's type, without
    gradient: a CPU tensor takes the plain version and a CUDA tensor
    launches K1 or raises, in the variant ``gat_fwd_plan`` names for the
    shape unless ``variant`` forces one, recorded in ``last_launch``.
    Grouped a and bias (``attention_groups``) give batch elements g B/G ..
    (g+1) B/G - 1 group g's in the same launch; under ``torch.func.vmap``
    the call is the custom op ``gatv2_attention_fwd_op``, whose rule folds
    the entities into those groups. K1 has no backward, so a call that
    autograd would record raises on both devices; ``gatv2_attention`` is the
    differentiable call."""
    if _needs_grad(p, q, a, bias, v):
        raise RuntimeError("gatv2_attention_fwd (K1) records no gradient; call "
                           "gatv2_attention, which trains through K1-res and K2")
    if _vmap.is_batched(p, q, a, bias, v):
        if variant is not None:
            raise ValueError("gatv2_attention_fwd under vmap runs the planned variant")
        return gatv2_attention_fwd_op(p, q, a, bias, v, alpha)
    if p.device.type == "cpu":
        return gatv2_attention_fwd_plain(p, q, a, bias, v, alpha)
    groups = _check("gatv2_attention_fwd", p, q, a, bias, v, grouped=True)
    B, N, E = p.shape
    D = v.shape[-1]
    if B == 0 or N == 0 or D == 0:
        return torch.empty((B, N, D), dtype=p.dtype, device=p.device)
    variant, row_blocks = _fwd_variant(N, E, D, variant)
    if variant == "tiled":             # the merge allocates the output
        (out, *_), plan = _fwd_tiled(p, q, a, bias, v, alpha, 0, 0.0, residuals=False,
                                     groups=groups)
        _count_fwd(gatv2_attention_fwd, variant, row_blocks, plan, groups)
        return out
    out = torch.empty((B, N, D), dtype=p.dtype, device=p.device)
    lib = _fwd_lib()
    p, q, a, v = (t.contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.to(torch.float32).contiguous()
    fn = lib.gatv2_fwd_f32 if p.dtype == torch.float32 else lib.gatv2_fwd_bf16
    with torch.cuda.device(p.device):
        err = fn(_ptr(p), _ptr(q), _ptr(a), _ptr(bias_c), _ptr(v), _ptr(out),
                 B, N, E, D, row_blocks, B // groups, float(alpha), _stream(p.device))
    _raise_on(err, f"gatv2_fwd {variant}")
    _count_fwd(gatv2_attention_fwd, variant, row_blocks, groups=groups)
    return out


gatv2_attention_fwd.launches = 0
gatv2_attention_fwd.launches_by_variant = {"graph": 0, "tiled": 0}
gatv2_attention_fwd.last_launch = None


@torch.library.custom_op("mtad_gat_tpu_torch::gatv2_attention_fwd", mutates_args=())
def gatv2_attention_fwd_op(p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
                           bias: Optional[torch.Tensor], v: torch.Tensor,
                           alpha: float) -> torch.Tensor:
    """``gatv2_attention_fwd`` as a custom op, the form a vmapped call takes
    (its vmap rule below)."""
    return gatv2_attention_fwd(p, q, a, bias, v, alpha)


def _gatv2_attention_fwd_vmap(info, in_dims, p, q, a, bias, v, alpha):
    """The entities' batch elements folded into one batch, their a and bias
    into K1's groups (``kernels/_vmap.py``): one grouped call whatever E is."""
    G = info.batch_size
    p_dim, q_dim, a_dim, bias_dim, v_dim, _ = in_dims
    _vmap.refuse_grad("K1", p, q, a, bias, v)
    out = gatv2_attention_fwd(_vmap.fold_rows(p, p_dim, G), _vmap.fold_rows(q, q_dim, G),
                              _vmap.fold_weight(a, a_dim, G, 1),
                              _vmap.fold_weight(bias, bias_dim, G, 2),
                              _vmap.fold_rows(v, v_dim, G), alpha)
    _gatv2_attention_fwd_vmap.calls += 1
    return _vmap.unfold_rows(out, G), 0


_gatv2_attention_fwd_vmap.calls = 0
gatv2_attention_fwd_op.register_vmap(_gatv2_attention_fwd_vmap)


def gatv2_attention_res(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
    seed: Seed = 0, rate: float = 0.0, variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1-res: (out (B, N, D) in v's type, u (B, N, D), m (B, N), l (B, N)
    float32), with attention dropout at ``rate`` keyed by ``seed``; the
    variant as ``gatv2_attention_fwd`` chooses it. Grouped a and bias
    (``attention_groups``) with one seed or G seeds (a (G,) int64 tensor)
    give batch elements g B/G .. (g+1) B/G - 1 group g's weights and seed,
    and their mask the batch index within the group, in one launch of the
    whole-graph or the tiled kernel.
    Records no autograd history; ``gatv2_attention`` is the differentiable
    call, and under ``torch.func.vmap`` its forward is the custom op
    ``gatv2_attention_res_op``."""
    if p.device.type == "cpu":
        return gatv2_attention_res_plain(p, q, a, bias, v, alpha, seed, rate)
    groups = _check("gatv2_attention_res", p, q, a, bias, v, grouped=True)
    B, N, E = p.shape
    D = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=p.device)
    outputs = lambda: (torch.empty((B, N, D), dtype=p.dtype, device=p.device),  # noqa: E731
                       torch.empty((B, N, D), **f32), torch.empty((B, N), **f32),
                       torch.empty((B, N), **f32))
    if B == 0 or N == 0 or D == 0:
        return outputs()
    variant, row_blocks = _fwd_variant(N, E, D, variant)
    if variant == "tiled":             # the merge allocates the outputs
        outs, plan = _fwd_tiled(p, q, a, bias, v, alpha, seed, rate, residuals=True,
                                groups=groups)
        _count_fwd(gatv2_attention_res, variant, row_blocks, plan, groups)
        return outs
    out, u, m, l = outputs()
    lib = _fwd_lib()
    p, q, a, v = (t.detach().contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.detach().to(torch.float32).contiguous()
    seed_t, thresh, scale = _drop_args(seed, rate, p.device, groups)
    fn = lib.gatv2_fwd_res_f32 if p.dtype == torch.float32 else lib.gatv2_fwd_res_bf16
    with torch.cuda.device(p.device):
        err = fn(_ptr(p), _ptr(q), _ptr(a), _ptr(bias_c), _ptr(v), _ptr(out),
                 _ptr(u), _ptr(m), _ptr(l), _ptr(seed_t), B, N, E, D, row_blocks,
                 B // groups, float(alpha), thresh, scale, _stream(p.device))
    _raise_on(err, f"gatv2_fwd_res {variant}")
    _count_fwd(gatv2_attention_res, variant, row_blocks, groups=groups)
    return out, u, m, l


gatv2_attention_res.launches = 0
gatv2_attention_res.launches_by_variant = {"graph": 0, "tiled": 0}
gatv2_attention_res.last_launch = None


def _bwd_launch(which: int, p, q, a, bias, v, m, l, du, dvec,
                alpha, seed, rate, outs, extra=(), groups: int = 1):
    """Launch K2c (2) or K2ab (3) writing into ``outs``; the caller has run
    ``_check`` and the layout checks of its kernel. ``groups``: K2ab's
    entity groups, one seed each."""
    B, N, E = p.shape
    D = v.shape[-1]
    lib = _bwd_lib()
    p, q, a, v = (t.detach().contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.detach().to(torch.float32).contiguous()
    m, l, du, dvec = (t.detach().to(torch.float32).contiguous() for t in (m, l, du, dvec))
    seed_t, thresh, scale = _drop_args(seed, rate, p.device, groups)
    kind = {2: "dbias", 3: "graph"}[which]
    dt = "f32" if p.dtype == torch.float32 else "bf16"
    fn = getattr(lib, f"gatv2_bwd_{kind}_{dt}")
    with torch.cuda.device(p.device):
        err = fn(_ptr(p), _ptr(q), _ptr(a), _ptr(bias_c), _ptr(v), _ptr(seed_t),
                 _ptr(m), _ptr(l), _ptr(du), _ptr(dvec), *(_ptr(t) for t in outs),
                 B, N, E, D, *extra, float(alpha), thresh, scale, _stream(p.device))
    _raise_on(err, f"gatv2_bwd_{kind}")


@functools.lru_cache(maxsize=None)
def _tiled_plan(B: int, N: int, E: int, D: int, sms: int, dbias: bool = False,
                groups: int = 1) -> Mapping[str, TiledKernelPlan]:
    """``gat_tiled_bwd_plan`` for a launch, refused where the built
    library's tile shapes, shared memory, K2a's key splits or K2b's batch
    group differ from the plan's (once per shape, entities and card)."""
    plans = gat_tiled_bwd_plan(B, N, E, D, sms, dbias=dbias, groups=groups)
    lib = _bwd_lib()
    for which, plan in enumerate(plans.values()):
        dims = (ctypes.c_int * 2)()
        lib.gatv2_bwd_tiled_tile(plan.tile, dims)
        built = (tuple(dims), lib.gatv2_bwd_tiled_smem_bytes(which, plan.tile, E, D,
                                                             int(plan.acc_smem)),
                 lib.gatv2_bwd_tiled_key_splits(plan.rows // 4 * -(-E // 4), plan.threads)
                 if which == 0 and plan.tile != CHUNKED else 1,
                 lib.gatv2_bwd_tiled_dbias_group(B, N, plan.tile, sms, B // groups)
                 if plan.dbias else 1)
        want = ((plan.rows, plan.keys), plan.smem_bytes, plan.key_splits, plan.group)
        if built != want:
            raise RuntimeError(f"gatv2 tiled backward {plan.kernel}: the built kernel's (tile, "
                               f"shared memory, key splits, batch group) {built} differ from "
                               f"the plan's {want}")
    return plans


def _tiled_launch(plan: TiledKernelPlan, p, q, a, bias, v, m, l, du, dvec, alpha, seed,
                  rate, outs, groups: int = 1) -> None:
    """Launch the tiled K2a or K2b of ``plan`` and its reduce, writing into
    ``outs`` (K2a: dp, da_part, part; K2b: dq, dv, the dbias partials or
    None, part); the caller has run ``_check``. The kernels read float32 p,
    q, a, v: bfloat16 ones are widened here (exactly), and the reduce writes
    the outputs in their type. ``groups``: the entity axis, one seed a
    group."""
    B, N, E = p.shape
    D = v.shape[-1]
    name = "dp_da" if plan.kernel == "k2a" else "dq_dv"
    dt = "f32" if p.dtype == torch.float32 else "bf16"
    p, q, a, v = (t.detach().to(torch.float32).contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.detach().to(torch.float32).contiguous()
    m, l, du, dvec = (t.detach().to(torch.float32).contiguous() for t in (m, l, du, dvec))
    seed_t, thresh, scale = _drop_args(seed, rate, p.device, groups)
    fn = getattr(_bwd_lib(), f"gatv2_bwd_{name}_{dt}")
    with torch.cuda.device(p.device):
        err = fn(_ptr(p), _ptr(q), _ptr(a), _ptr(bias_c), _ptr(v), _ptr(seed_t),
                 _ptr(m), _ptr(l), _ptr(du), _ptr(dvec), *(_ptr(t) for t in outs),
                 B, N, E, D, plan.tile, plan.slices, int(plan.acc_smem),
                 *((plan.group,) if plan.kernel == "k2b" else ()), B // groups,
                 float(alpha), thresh, scale, _stream(p.device))
    _raise_on(err, f"gatv2_bwd_{name}")


def _launch_plan(kernel: str, B: int, N: int, E: int, D: int, device, groups: int,
                 dbias: bool, plan: Optional[TiledKernelPlan]) -> TiledKernelPlan:
    """The plan a tiled K2a or K2b launch runs: ``_tiled_plan``'s, or the
    caller's ``plan`` (its tile, slices, place of the running sums and
    batch group; a grouped launch's, so that G ungrouped launches can be
    held against it bit for bit)."""
    if plan is None:
        plan = _tiled_plan(B, N, E, D, _build.sm_count(device), dbias, groups)[kernel]
    elif plan.kernel != kernel or plan.dbias != dbias:
        raise ValueError(f"gatv2 tiled backward: a {plan.kernel} plan (dbias {plan.dbias}) for "
                         f"a {kernel} launch (dbias {dbias})")
    return plan


def _entity_da(da_part: torch.Tensor, plan: TiledKernelPlan, groups: int) -> torch.Tensor:
    """K2a's da rows (slices, B, row tiles, E), a block's one row (four,
    one a row group, with the CHUNKED tile), to (G, E): each entity's rows
    gathered slice by slice, then summed as its ungrouped launch's caller
    sums its own (``_entity_sums``)."""
    if plan.slices > 1:
        S, E = plan.slices, da_part.shape[-1]
        da_part = da_part.view(S, groups, -1, E).transpose(0, 1).reshape(-1, E)
    return _entity_sums(da_part, groups)


def gatv2_bwd_dp_da(p, q, a, bias, v, m, l, du, dvec, alpha: float,
                    seed: Seed = 0, rate: float = 0.0,
                    plan: Optional[TiledKernelPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2a on CUDA tensors: dp (B, N, E) in p's type and da (E,) float32,
    from the forward's row stats m, l (B, N), du = g . out (1 - out)
    (B, N, D) and dvec = sum_d du . u (B, N), through the launch
    ``gat_tiled_bwd_plan`` gives, or ``plan`` (``_launch_plan``), recorded
    in ``last_plan``: the kernel, then the sum of its slices' partials.
    Grouped a and bias (``attention_groups``) with one seed or G seeds give
    each entity of B / G rows its weights, seed and batch index within the
    entity, and da (G, E) each summed over its own rows in its launch's
    order, at every tile. The CPU computes
    all of K2a-c in one call of ``gatv2_attention_bwd_plain``."""
    groups = _check("gatv2_bwd_dp_da", p, q, a, bias, v, grouped=True)
    B, N, E = p.shape
    D = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=p.device)
    if B == 0 or N == 0 or D == 0:          # no values: every gradient is 0
        return torch.zeros(p.shape, dtype=p.dtype, device=p.device), torch.zeros(a.shape, **f32)
    plan = _launch_plan("k2a", B, N, E, D, p.device, groups, False, plan)
    dp = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    da_part = torch.empty((plan.slices * B * -(-N // plan.rows)
                           * (plan.rows // 4 if plan.tile == CHUNKED else 1), E), **f32)
    part = torch.empty((plan.slices, B, N, E), **f32)
    _tiled_launch(plan, p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate, (dp, da_part, part),
                  groups)
    gatv2_bwd_dp_da.launches += 1
    gatv2_bwd_dp_da.launches_by_variant[TILED_TILE_NAMES[plan.tile]] += 1
    gatv2_bwd_dp_da.last_plan = plan
    if a.dim() == 2:
        return dp, _entity_da(da_part, plan, groups)
    return dp, da_part.sum(dim=0)


gatv2_bwd_dp_da.launches = 0
gatv2_bwd_dp_da.launches_by_variant = dict.fromkeys(TILED_TILE_NAMES, 0)
gatv2_bwd_dp_da.last_plan = None


def gatv2_bwd_dq_dv(p, q, a, bias, v, m, l, du, dvec, alpha: float, seed: Seed = 0,
                    rate: float = 0.0, dbias: bool = False,
                    plan: Optional[TiledKernelPlan] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K2b on CUDA tensors: dq (B, N, E) in q's type, dv (B, N, D) in v's
    type and, with ``dbias``, K2c's dbias (N, N) float32 from the same pass
    (each block summing ds over ``tiled_dbias_groups`` batch elements, the
    groups' partials then summed in order), else None; inputs, plan,
    entity axis and ``last_plan`` as ``gatv2_bwd_dp_da``: grouped, each
    entity's rows are cut into its own runs of the batch group
    (``graph_block_batches``) and dbias is (G, N, N), each entity's
    partials summed in its launch's order. Counts its launches by tile and,
    under ``launches_by_variant`` "dbias" and "no_dbias", by whether they
    summed dbias."""
    groups = _check("gatv2_bwd_dq_dv", p, q, a, bias, v, grouped=True)
    if dbias and bias is None:
        raise ValueError("gatv2_bwd_dq_dv: dbias asked for a call without a bias")
    B, N, E = p.shape
    D = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=p.device)
    if B == 0 or N == 0 or D == 0:          # no values: every gradient is 0
        return (torch.zeros_like(q), torch.zeros_like(v),
                torch.zeros(bias.shape, **f32) if dbias else None)
    plan = _launch_plan("k2b", B, N, E, D, p.device, groups, dbias, plan)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    runs = groups * -(-(B // groups) // plan.group)
    dpart = torch.empty((runs, N, N), **f32) if dbias else None
    part = torch.empty((plan.slices, B, N, E + D), **f32)
    _tiled_launch(plan, p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate,
                  (dq, dv, dpart, part), groups)
    gatv2_bwd_dq_dv.launches += 1
    gatv2_bwd_dq_dv.launches_by_variant[TILED_TILE_NAMES[plan.tile]] += 1
    gatv2_bwd_dq_dv.launches_by_variant["dbias" if dbias else "no_dbias"] += 1
    gatv2_bwd_dq_dv.last_plan = plan
    if a.dim() == 2:
        return dq, dv, None if dpart is None else _entity_sums(dpart, groups)
    if dpart is not None and dpart.shape[0] > 1:
        dpart = dpart.sum(dim=0)
    return dq, dv, None if dpart is None else dpart.view(N, N)


gatv2_bwd_dq_dv.launches = 0
gatv2_bwd_dq_dv.launches_by_variant = dict.fromkeys(TILED_TILE_NAMES + ("dbias", "no_dbias"), 0)
gatv2_bwd_dq_dv.last_plan = None


@functools.lru_cache(maxsize=None)
def _streamed_plan(B: int, N: int, E: int, D: int, sms: int, dbias: bool) -> StreamedPlan:
    """``gat_streamed_bwd_plan`` for a launch, refused where the built
    library's layout (threads, shared memory, key registers, columns, chunk,
    NMAX, buffers) differs from the plan's (once per shape and card)."""
    plan = gat_streamed_bwd_plan(B, N, E, D, sms, dbias=dbias)
    out = (ctypes.c_long * 8)()
    _streamed_lib().gatv2_streamed_layout(N, plan.rows, plan.rows_per_thread, out)
    want = (plan.score_threads, plan.score_smem_bytes, plan.key_regs, plan.cols,
            plan.contract_smem_bytes, plan.chunk, STREAMED_NMAX, STREAMED_RING)
    if tuple(out) != want:
        raise RuntimeError(f"gatv2_bwd_streamed: the built kernels' layout {tuple(out)} differs "
                           f"from the plan's {want}")
    return plan


def _streamed_launch(plan: StreamedPlan, p, q, a, bias, v, m, l, du, dvec, alpha, seed,
                     rate, outs, groups: int = 1) -> None:
    """Launch both passes of the streamed backward as ``plan`` says,
    writing into ``outs`` (ds, wa, dp, dq, dv, da_part, dbias or None); the
    caller has run ``_check``. The kernels read float32 p, q, a, v:
    bfloat16 ones are widened here (exactly), and dp, dq, dv are written in
    their inputs' type. ``groups``: the entity axis, one seed a group and
    dbias (G, N, N)."""
    B, N, E = p.shape
    D = v.shape[-1]
    dt = "f32" if p.dtype == torch.float32 else "bf16"
    p, q, a, v = (t.detach().to(torch.float32).contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.detach().to(torch.float32).contiguous()
    m, l, du, dvec = (t.detach().to(torch.float32).contiguous() for t in (m, l, du, dvec))
    seed_t, thresh, scale = _drop_args(seed, rate, p.device, groups)
    fn = getattr(_streamed_lib(), f"gatv2_streamed_{dt}")
    with torch.cuda.device(p.device):
        err = fn(_ptr(p), _ptr(q), _ptr(a), _ptr(bias_c), _ptr(v), _ptr(seed_t), _ptr(m),
                 _ptr(l), _ptr(du), _ptr(dvec), *(_ptr(t) for t in outs), B, N, E, D,
                 plan.rows, plan.rows_per_thread, B // groups, float(alpha), thresh, scale,
                 _stream(p.device))
    _raise_on(err, "gatv2_streamed")


def gatv2_bwd_streamed(p, q, a, bias, v, m, l, du, dvec, alpha: float, seed: Seed = 0,
                       rate: float = 0.0, dbias: bool = False) -> Tuple[torch.Tensor, ...]:
    """The streamed backward on CUDA tensors (``csrc/gat_streamed.cu``):
    (dp, dq, da, dv, dbias), K2a's and K2b's outputs and, with ``dbias``,
    K2c's dbias (N, N) float32 (else None), from a score pass that writes
    ds and wa (B, N, N) float32 and a contraction pass over chunks of E and
    D; inputs as ``gatv2_bwd_dp_da``, N at most ``streamed_nmax``; dp, dq,
    dv in their inputs' type. Grouped a and bias (``attention_groups``) with
    one seed or G seeds give each entity of B / G rows its weights, seed and
    batch index within the entity, da (G, E) summed over its own rows as
    its launch sums them and dbias (G, N, N) over its own rows in order, in
    one launch. Counts its launches (both passes, one call), those that
    summed dbias under ``launches_by_variant``, and keeps its plan in
    ``last_plan``. The CPU computes the backward in one call of
    ``gatv2_attention_bwd_plain``."""
    groups = _check("gatv2_bwd_streamed", p, q, a, bias, v, grouped=True)
    if dbias and bias is None:
        raise ValueError("gatv2_bwd_streamed: dbias asked for a call without a bias")
    B, N, E = p.shape
    D = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=p.device)
    if B == 0 or N == 0 or D == 0:          # no values: every gradient is 0
        return (torch.zeros_like(p), torch.zeros_like(q), torch.zeros(a.shape, **f32),
                torch.zeros_like(v), torch.zeros(bias.shape, **f32) if dbias else None)
    plan = _streamed_plan(B, N, E, D, _build.sm_count(p.device), dbias)
    dp = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    da_part = torch.empty((B, E), **f32)
    dbias_out = torch.empty(bias.shape, **f32) if dbias else None
    _streamed_launch(plan, p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate,
                     (torch.empty((B, N, N), **f32), torch.empty((B, N, N), **f32), dp, dq, dv,
                      da_part, dbias_out), groups)
    gatv2_bwd_streamed.launches += 1
    gatv2_bwd_streamed.launches_by_variant["dbias" if dbias else "no_dbias"] += 1
    gatv2_bwd_streamed.last_plan = plan
    if a.dim() == 2:
        return dp, dq, _entity_sums(da_part, groups), dv, dbias_out
    return dp, dq, da_part.sum(dim=0), dv, dbias_out


gatv2_bwd_streamed.launches = 0
gatv2_bwd_streamed.launches_by_variant = {"dbias": 0, "no_dbias": 0}
gatv2_bwd_streamed.last_plan = None


@functools.lru_cache(maxsize=None)
def _check_graph_layout(N: int, E: int, D: int) -> None:
    """Refuse a shape K2ab cannot hold, and a built kernel whose shared
    memory, score split or row groups this module no longer mirrors (once
    per shape)."""
    if gat_bwd_plan(N, E, D) != "graph":
        raise ValueError(f"gatv2_bwd_graph: a graph of {N} nodes at widths E {E}, D {D} "
                         "does not fit a block; gat_bwd_plan routes it to K2a and K2b")
    lib = _bwd_lib()
    built = (lib.gatv2_bwd_smem_bytes(3, N, E, D), lib.gatv2_bwd_graph_split(),
             lib.gatv2_bwd_graph_row_groups(N))
    if built != (gat_bwd_smem_bytes(N, E, D), GRAPH_SPLIT, graph_row_groups(N)):
        raise RuntimeError(f"gatv2_bwd_graph: the built kernel's (shared memory, split, "
                           f"row groups) {built} differ from this module's")


@functools.lru_cache(maxsize=None)
def _check_dbias_group(B: int, sms: int) -> int:
    """``dbias_groups`` for a launch, refused where the built kernel's own
    rule gives another group (once per batch and card)."""
    group = dbias_groups(B, sms)
    built = _bwd_lib().gatv2_bwd_graph_dbias_group(B, sms)
    if built != group:
        raise RuntimeError(f"gatv2_bwd_graph: the built kernel groups {built} batch elements "
                           f"a block at batch {B} on {sms} multiprocessors, this module {group}")
    return group


def _entity_sums(part: torch.Tensor, groups: int) -> torch.Tensor:
    """(G P, ...) float32 partials, P an entity's, to (G, ...): each
    entity's P summed as an ungrouped call at its rows sums its own
    (``part[0]`` where P is 1, else ``sum(dim=0)`` over its slice), so
    that a grouped launch gives G ungrouped launches' bits."""
    P = part.shape[0] // groups
    if P == 1:
        return part
    return torch.stack([part[g * P:(g + 1) * P].sum(dim=0) for g in range(groups)])


def gatv2_bwd_graph(p, q, a, bias, v, m, l, du, dvec, alpha: float, seed: Seed = 0,
                    rate: float = 0.0, dbias: bool = False) -> Tuple[torch.Tensor, ...]:
    """K2ab on CUDA tensors: K2a's and K2b's outputs (dp, dq, da, dv) in one
    launch, one block per batch element holding its whole graph, and, with
    ``dbias``, K2c's dbias (N, N) float32 from the same pass, each block
    summing ds over ``dbias_groups`` batch elements (else None); inputs as
    ``gatv2_bwd_dp_da``. Grouped a and bias (``attention_groups``) with one
    seed or G seeds give each group of B / G rows its weights, seed and
    batch index within the group, its blocks' batch runs those of an
    ungrouped launch at its rows (``graph_block_batches``), and da (G, E)
    and dbias (G, N, N) each summed over its own rows in that launch's
    order. Raises where ``gat_bwd_plan`` names "tiled". Counts its
    launches, and those that summed dbias under ``launches_by_variant``;
    ``last_launch`` holds the groups and the batch elements a block."""
    groups = _check("gatv2_bwd_graph", p, q, a, bias, v, grouped=True)
    if dbias and bias is None:
        raise ValueError("gatv2_bwd_graph: dbias asked for a call without a bias")
    B, N, E = p.shape
    D = v.shape[-1]
    rows = B // groups
    f32 = dict(dtype=torch.float32, device=p.device)
    dp = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if B == 0 or N == 0:
        return (dp, dq, torch.zeros(a.shape, **f32), dv,
                torch.zeros(bias.shape, **f32) if dbias else None)
    _check_graph_layout(N, E, D)
    group = _check_dbias_group(rows, _build.sm_count(p.device)) if dbias else 1
    da_part = torch.empty((B, E), **f32)
    part = torch.empty((groups * -(-rows // group), N, N), **f32) if dbias else None
    _bwd_launch(3, p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate,
                (dp, dq, dv, da_part, part), (group, rows), groups)
    gatv2_bwd_graph.launches += 1
    gatv2_bwd_graph.launches_by_variant["dbias" if dbias else "no_dbias"] += 1
    gatv2_bwd_graph.last_launch = {"groups": groups, "group": group}
    if a.dim() == 2:
        return (dp, dq, _entity_sums(da_part, groups), dv,
                None if part is None else _entity_sums(part, groups))
    dbias_sum = None
    if part is not None:
        dbias_sum = part[0] if part.shape[0] == 1 else part.sum(dim=0)
    return dp, dq, da_part.sum(dim=0), dv, dbias_sum


gatv2_bwd_graph.launches = 0
gatv2_bwd_graph.launches_by_variant = {"dbias": 0, "no_dbias": 0}
gatv2_bwd_graph.last_launch = None


def dbias_kernel(N: int, E: int, D: int) -> str:
    """The kernel that gives dbias (K2c's function) in the backward of a
    graph of N nodes at widths E and D, by ``gat_bwd_route``: "k2ab" (the
    whole-graph kernel), "k2b" (the tiled K2b, in its own pass) or
    "streamed" (the streamed backward's contraction pass). No path launches
    K2c itself."""
    return {"graph": "k2ab", "tiled": "k2b", "streamed": "streamed"}[gat_bwd_route(N, E, D)]


def gatv2_bwd(p, q, a, bias, v, m, l, du, dvec, alpha: float, seed: Seed = 0,
              rate: float = 0.0, dbias: bool = False) -> Tuple[torch.Tensor, ...]:
    """The attention backward on CUDA tensors: (dp, dq, da, dv, dbias)
    through the variant ``gat_bwd_route`` names for the shape, K2ab alone
    ("graph"), K2a then K2b ("tiled") or the streamed backward
    ("streamed"), dbias from the same launch (``dbias_kernel``), recorded in
    ``gatv2_bwd.last_launch`` with the kernel that gave dbias; dbias is None
    unless asked for. Grouped a and bias (an entity axis) take every
    route."""
    _, N, E = p.shape
    shape = (max(N, 1), E, max(v.shape[-1], 1))
    variant = gat_bwd_route(*shape)
    args = (p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate)
    if variant == "graph":
        out = gatv2_bwd_graph(*args, dbias=dbias)
    elif variant == "streamed":
        out = gatv2_bwd_streamed(*args, dbias=dbias)
    else:
        dp, da = gatv2_bwd_dp_da(*args)
        dq, dv, db = gatv2_bwd_dq_dv(*args, dbias=dbias)
        out = (dp, dq, da, dv, db)
    gatv2_bwd.last_launch = {"variant": variant,
                             "dbias": dbias_kernel(*shape) if dbias else None}
    return out


gatv2_bwd.last_launch = None


def dbias_chunks(B: int, N: int, sms: int) -> int:
    """Batch chunks of K2c on a card of ``sms`` multiprocessors: enough
    blocks for two per SM when the (i, j) tiles alone are fewer, each chunk
    non-empty."""
    tiles = -(-N // _BI) * -(-N // _BJ)
    want = max(1, min(B, -(-2 * sms // tiles)))
    chunk = -(-B // want)
    return -(-B // chunk)


def dbias_smem_bytes(E: int, D: int, chunk: int) -> int:
    """Shared memory of one K2c block (``tile_floats``) at widths E, D
    staged whole (chunk 0) or ``chunk`` floats of each at a time: p, du
    [16][odd], q, v [32][odd], a, m, l and dvec, float32."""
    odd = lambda x: x | 1  # noqa: E731
    ec = min(chunk, E) if chunk else E
    dc = min(chunk, D) if chunk else D
    return 4 * ((_BI + _BJ) * (odd(ec) + odd(dc)) + ec + 3 * _BI)


def dbias_chunk(E: int, D: int, smem_limit: int = _SMEM_LIMIT) -> int:
    """K2c's staged widths: 0 (E and D whole, its first design's tile) where
    that block fits ``smem_limit`` bytes (the feature layer up to window
    400), else ``DBIAS_CHUNK`` floats of each, which fits at every width."""
    if min(E, D) < 1:
        raise ValueError(f"dbias_chunk: empty width (E {E}, D {D})")
    return 0 if dbias_smem_bytes(E, D, 0) <= smem_limit else DBIAS_CHUNK


@functools.lru_cache(maxsize=None)
def _check_dbias_layout(E: int, D: int, chunk: int) -> None:
    """Refuse a built K2c whose shared memory this module no longer mirrors
    (once per widths)."""
    built = _bwd_lib().gatv2_bwd_dbias_smem_bytes(E, D, chunk)
    if built != dbias_smem_bytes(E, D, chunk):
        raise RuntimeError(f"gatv2_bwd_dbias: the built kernel's shared memory {built} "
                           f"differs from this module's {dbias_smem_bytes(E, D, chunk)}")


def gatv2_bwd_dbias(p, q, a, bias, v, m, l, du, dvec, alpha: float,
                    seed: Seed = 0, rate: float = 0.0,
                    variant: Optional[str] = None) -> torch.Tensor:
    """K2c on CUDA tensors: dbias (N, N) float32 = sum over the batch of
    ds; inputs as ``gatv2_bwd_dp_da``, bias not None. Its widths staged as
    ``dbias_chunk`` says ("full" or "chunked", counted under
    ``launches_by_variant``), unless ``variant`` forces "chunked". On no
    path: K2ab and K2b give dbias in their own pass (``dbias_kernel``); it
    runs only where a caller asks for it, as the yardstick they are timed
    against."""
    if bias is None:
        raise ValueError("gatv2_bwd_dbias: the call has no bias")
    _check("gatv2_bwd_dbias", p, q, a, bias, v)
    B, N, E = p.shape
    D = v.shape[-1]
    if B == 0 or N == 0 or D == 0:
        return torch.zeros((N, N), dtype=torch.float32, device=p.device)
    if variant not in (None, "chunked"):
        raise ValueError(f"gatv2_bwd_dbias: variant {variant!r} is not 'chunked'")
    chunk = DBIAS_CHUNK if variant == "chunked" else dbias_chunk(E, D)
    _check_dbias_layout(E, D, chunk)
    n_chunks = dbias_chunks(B, N, _build.sm_count(p.device))
    part = torch.empty((n_chunks, N, N), dtype=torch.float32, device=p.device)
    _bwd_launch(2, p, q, a, bias, v, m, l, du, dvec, alpha, seed,
                rate, (part,), (n_chunks, chunk))
    gatv2_bwd_dbias.launches += 1
    gatv2_bwd_dbias.launches_by_variant["chunked" if chunk else "full"] += 1
    return part[0] if n_chunks == 1 else part.sum(dim=0)


gatv2_bwd_dbias.launches = 0
gatv2_bwd_dbias.launches_by_variant = {"full": 0, "chunked": 0}


# ---------------------------------------------------------------------------
# The differentiable call: mtad_gat_tpu/kernels/gat_pallas.py::_fused
# (custom VJP, :752-778).
# ---------------------------------------------------------------------------


def _seed_tensor(seed: Seed, rate: float, device) -> Optional[torch.Tensor]:
    """The ops' seed: None without dropout, else a tensor (an int becomes one
    int64 value on the device, every entity's under vmap)."""
    if rate <= 0.0:
        return None
    if isinstance(seed, torch.Tensor):
        return seed
    return torch.full((1,), seed_int(seed), dtype=torch.int64, device=device)


@torch.library.custom_op("mtad_gat_tpu_torch::gatv2_attention_res", mutates_args=())
def gatv2_attention_res_op(p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
                           bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
                           seed: Optional[torch.Tensor], rate: float
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gatv2_attention_res`` as a custom op, the form the forward of a
    vmapped training call takes (its vmap rule below)."""
    return gatv2_attention_res(p, q, a, bias, v, alpha, 0 if seed is None else seed, rate)


def _fold_seed(seed, dim, groups):
    """The entities' seeds, one value each, as a (G,) tensor (an unbatched
    seed expanded), or None without dropout."""
    return None if seed is None else _vmap.fold_weight(seed, dim, groups, 1).reshape(-1)


def _gatv2_attention_res_vmap(info, in_dims, p, q, a, bias, v, alpha, seed, rate):
    """The entities' batch elements folded into one batch, their a, bias and
    seeds into K1-res's groups: one grouped launch whatever E is."""
    G = info.batch_size
    p_dim, q_dim, a_dim, bias_dim, v_dim, _, seed_dim, _ = in_dims
    seeds = _fold_seed(seed, seed_dim, G)
    outs = gatv2_attention_res(
        _vmap.fold_rows(p, p_dim, G), _vmap.fold_rows(q, q_dim, G),
        _vmap.fold_weight(a, a_dim, G, 1), _vmap.fold_weight(bias, bias_dim, G, 2),
        _vmap.fold_rows(v, v_dim, G), alpha, 0 if seeds is None else seeds, rate)
    _gatv2_attention_res_vmap.calls += 1
    return tuple(_vmap.unfold_rows(t, G) for t in outs), (0, 0, 0, 0)


_gatv2_attention_res_vmap.calls = 0
gatv2_attention_res_op.register_vmap(_gatv2_attention_res_vmap)


def _attention_bwd(p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate, need_dbias):
    """(dp, dq, da, dv, dbias) of the attention under du = g . out (1 - out)
    and dvec = sum_d du . u: the plain backward on CPU tensors, the route's
    kernels (``gatv2_bwd``) on CUDA tensors, dbias None unless asked for."""
    if p.device.type == "cpu":
        # the plain backward derives its gradients by autograd
        with _vmap.autograd_in_rule():
            dp, dq, da, dbias, dv = gatv2_attention_bwd_plain(p, q, a, bias, v, du, alpha,
                                                              seed, rate)
        return dp, dq, da, dv, dbias if need_dbias else None
    return gatv2_bwd(p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate, dbias=need_dbias)


@torch.library.custom_op("mtad_gat_tpu_torch::gatv2_attention_bwd", mutates_args=())
def gatv2_attention_bwd_op(p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
                           bias: Optional[torch.Tensor], v: torch.Tensor, m: torch.Tensor,
                           l: torch.Tensor, du: torch.Tensor, dvec: torch.Tensor, alpha: float,
                           seed: Optional[torch.Tensor], rate: float, need_dbias: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The attention backward as a custom op, the form a vmapped backward
    takes (its vmap rule below): (dp, dq, da, dv, dbias), dbias an empty
    tensor unless ``need_dbias``."""
    dp, dq, da, dv, dbias = _attention_bwd(p, q, a, bias, v, m, l, du, dvec, alpha,
                                           0 if seed is None else seed, rate, need_dbias)
    return dp, dq, da, dv, dbias if dbias is not None else da.new_empty(0)


def _gatv2_attention_bwd_vmap(info, in_dims, p, q, a, bias, v, m, l, du, dvec, alpha, seed,
                              rate, need_dbias):
    """The entities' rows folded into one batch, their a, bias and seeds
    into the backward's groups: one grouped call of the route's kernels
    whatever E is, each entity's da and dbias its own (an unbatched a or
    bias gets one an entity)."""
    G = info.batch_size
    p_dim, q_dim, a_dim, bias_dim, v_dim, m_dim, l_dim, du_dim, dvec_dim = in_dims[:9]
    seeds = _fold_seed(seed, in_dims[10], G)
    af = _vmap.fold_weight(a, a_dim, G, 1)
    biasf = _vmap.fold_weight(bias, bias_dim, G, 2)
    dp, dq, da, dv, dbias = _attention_bwd(
        _vmap.fold_rows(p, p_dim, G), _vmap.fold_rows(q, q_dim, G), af, biasf,
        _vmap.fold_rows(v, v_dim, G), _vmap.fold_rows(m, m_dim, G),
        _vmap.fold_rows(l, l_dim, G), _vmap.fold_rows(du, du_dim, G),
        _vmap.fold_rows(dvec, dvec_dim, G), alpha, 0 if seeds is None else seeds, rate,
        need_dbias)
    _gatv2_attention_bwd_vmap.calls += 1
    # nested vmaps: an entity's weights were already grouped, so are its grads
    lead = (G,) if a.dim() - (a_dim is not None) == 1 else (G, -1)
    da = da.reshape(*lead, da.shape[-1])
    if dbias is None:
        return (_vmap.unfold_rows(dp, G), _vmap.unfold_rows(dq, G), da,
                _vmap.unfold_rows(dv, G), da.new_empty(0)), (0, 0, 0, 0, None)
    return (_vmap.unfold_rows(dp, G), _vmap.unfold_rows(dq, G), da, _vmap.unfold_rows(dv, G),
            dbias.reshape(*lead, *dbias.shape[-2:])), (0, 0, 0, 0, 0)


_gatv2_attention_bwd_vmap.calls = 0
gatv2_attention_bwd_op.register_vmap(_gatv2_attention_bwd_vmap)


class _GATv2Attention(torch.autograd.Function):
    """K1-res forward, K2ab (or K2a then K2b, or the streamed backward)
    backward; returns (out, u, m, l), the last three saved for the backward
    and not differentiable. ``torch.func`` transforms it too: under them its
    forward is K1-res's custom op and its backward the backward's op, under
    vmap each folding the entities into one grouped launch
    (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(p, q, a, bias, v, alpha, seed, rate):
        if _vmap.is_wrapped(p, q, a, bias, v):
            return gatv2_attention_res_op(p, q, a, bias, v, alpha,
                                          _seed_tensor(seed, rate, p.device), rate)
        return gatv2_attention_res(p, q, a, bias, v, alpha, seed, rate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        p, q, a, bias, v, alpha, seed, rate = inputs
        _, u, m, l = output
        ctx.mark_non_differentiable(u, m, l)
        ctx.save_for_backward(p, q, a, bias, v, u, m, l,
                              seed if isinstance(seed, torch.Tensor) else None)
        ctx.alpha, ctx.rate = alpha, rate
        ctx.seed = None if isinstance(seed, torch.Tensor) else seed

    @staticmethod
    def backward(ctx, g, *_):
        p, q, a, bias, v, u, m, l, seed_t = ctx.saved_tensors
        if not _vmap.is_wrapped(p, q, a, bias, v, u, g):
            return _GATv2Attention._solo_backward(ctx, g)
        p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate, need = \
            _GATv2Attention._bwd_args(ctx, g)
        with torch.no_grad():
            dp, dq, da, dv, dbias = gatv2_attention_bwd_op(
                p, q, a, bias, v, m, l, du, dvec, alpha, _seed_tensor(seed, rate, p.device),
                rate, need)
        return _GATv2Attention._cast(ctx, dp, dq, da, dv, dbias if need else None)

    @staticmethod
    @once_differentiable
    def _solo_backward(ctx, g):
        """The backward of a call outside ``torch.func`` transforms,
        straight to the wrappers (or the plain version); a second derivative
        through it raises."""
        return _GATv2Attention._cast(ctx, *_attention_bwd(*_GATv2Attention._bwd_args(ctx, g)))

    @staticmethod
    def _bwd_args(ctx, g):
        """``_attention_bwd``'s arguments: du = g . out (1 - out) and dvec =
        sum_d du . u outside the kernels, as ``_fused_backward`` computes
        them (:610-612), and dbias where the bias needs a gradient."""
        p, q, a, bias, v, u, m, l, seed_t = ctx.saved_tensors
        out = torch.sigmoid(u)
        du = g.float() * out * (1.0 - out)
        dvec = (du * u).sum(dim=-1)
        return (p, q, a, bias, v, m, l, du, dvec, ctx.alpha,
                seed_t if seed_t is not None else ctx.seed, ctx.rate,
                bias is not None and ctx.needs_input_grad[3])

    @staticmethod
    def _cast(ctx, dp, dq, da, dv, dbias):
        p, q, a, bias, v = ctx.saved_tensors[:5]
        return (dp.to(p.dtype), dq.to(q.dtype), da.to(a.dtype),
                None if dbias is None else dbias.to(bias.dtype), dv.to(v.dtype),
                None, None, None)


def chunked_tile(N: int, E: int, D: int) -> bool:
    """Whether the backward of a graph of N nodes at widths E and D runs
    the CHUNKED tiled K2a or K2b (``gat_bwd_route`` "tiled" beyond the
    widths the FAST and WIDE tiles take)."""
    return gat_bwd_route(N, E, D) == "tiled" and any(
        _tiled_tile(k, E, D, _SMEM_LIMIT)[0] == CHUNKED for k in ("k2a", "k2b"))


def gatv2_attention(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
    seed: Seed = 0, rate: float = 0.0, train: bool = False,
) -> torch.Tensor:
    """Fused GATv2 attention with gradients and attention dropout at
    ``rate`` (0 in eval), keyed by ``seed`` (an int, or one int64 value on
    the inputs' device). Where a gradient is needed, or dropout is on, or
    ``train`` says so (the no-grad forward of a recomputed layer,
    ``nn/remat.py``, which must give a training call's bits), it runs K1-res
    forward (and K2ab, or K2a then K2b, or the streamed backward, backward);
    otherwise K1 alone. Under ``torch.func.vmap`` each is one grouped launch
    for all entities, each with its own weights and seed, whatever the plan
    and route."""
    if train or rate > 0.0 or _vmap.requires_grad(p, q, a, bias, v):
        return _GATv2Attention.apply(p, q, a, bias, v, alpha, seed, rate)[0]
    return gatv2_attention_fwd(p, q, a, bias, v, alpha)
