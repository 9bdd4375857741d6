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
  softmax) or the tiled one (16-row tiles, online softmax), as
  ``gat_fwd_plan`` decides;
- K2a ``gatv2_bwd_dp_da``, K2b ``gatv2_bwd_dq_dv``, K2c ``gatv2_bwd_dbias``:
  ``_bwd_dp_da_kernel``, ``_bwd_dq_dv_kernel``, ``_bwd_dbias_kernel``;
- K2ab ``gatv2_bwd_graph``: K2a and K2b in one launch for a graph that fits
  a block whole (the model's), each (i, j) pair scored once.
  ``gatv2_bwd`` runs K2ab or K2a then K2b, as ``gat_bwd_plan`` decides.

What bounds them on the card: the score is float32 work on the CUDA cores
(4 operations per (i, j, e), recomputed by each tiled backward kernel and
once by K2ab, then one multiply-add per (i, j, e) for each of the
backward's contractions), with no
product structure for the tensor cores; at the model's
graph sizes that work outweighs the bytes of the inputs. Every kernel keeps
its tiles' operands in shared memory and recomputes weights from (m, l), so
no (N, N) tensor is written to device memory except dbias itself
(``csrc/gat_fwd.cu`` and ``csrc/gat_bwd.cu`` say more). The TPU kernels'
VMEM tiling plan (``_Plan``) and lane padding are not carried over: the CUDA
kernels pick their own tiles and mask ragged edges.

The dropout mask is a hash of the global (seed, batch index, row, column),
bit for bit the JAX package's ``_hash_u32`` / ``_keep_threshold``; its plain
form is ``hash_keep_mask``. The seed is a one-element int64 tensor on the
device, drawn there from the step's generator, so no launch waits on the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from mtad_gat_tpu_torch.graph.ops import gat_aggregate_dense, gatv2_scores_dense
from mtad_gat_tpu_torch.kernels import _build

# Largest (batch chunk x N x N x E) float32 temporary the plain versions
# build at once, to bound their memory at large batches.
_PLAIN_CHUNK_ELEMS = 1 << 26
_SMEM_LIMIT = 227 * 1024
_BI, _BJ = 16, 32                 # the CUDA kernels' row and key tiles

Seed = Union[int, torch.Tensor]

# ---------------------------------------------------------------------------
# The dropout hash: gat_pallas.py:87-147, in int64 with every product kept
# below 2**63, so no step relies on signed wraparound.
# ---------------------------------------------------------------------------

_DROP_C1 = 0x9E3779B9
_DROP_C2 = 0x85EBCA6B
_DROP_C3 = 0xC2B2AE35
_DROP_CB = 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the product is split at
    16 bits of c so that no partial product reaches 2**49."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & _M32


def _hash_u32(seed: int, b: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_hash_u32`` over int64 tensors holding uint32
    values; broadcasts b, rows and cols against each other."""
    x = (seed & _M32) ^ _mul32(b, _DROP_CB) ^ _mul32(rows, _DROP_C1) ^ _mul32(cols, _DROP_C2)
    x = x ^ (x >> 16)
    x = _mul32(x, _DROP_C2)
    x = x ^ (x >> 13)
    x = _mul32(x, _DROP_C3)
    return x ^ (x >> 16)


def _keep_threshold(rate: float) -> int:
    """uint32 threshold for P(keep) = 1 - rate, clamped so that a tiny rate
    cannot round to 2**32 (which would drop everything under wraparound)."""
    return min(int(round((1.0 - rate) * 4294967296.0)), 4294967295)


def hash_keep_mask(seed: Seed, batch: int, n_rows: int, n_cols: int, rate: float,
                   batch_offset: int = 0, device=None) -> torch.Tensor:
    """(batch, n_rows, n_cols) bool keep mask of the kernels' dropout, for
    batch indices ``batch_offset`` .. ``batch_offset + batch - 1`` of a call."""
    i64 = dict(dtype=torch.int64, device=device)
    b = torch.arange(batch_offset, batch_offset + batch, **i64)[:, None, None]
    rows = torch.arange(n_rows, **i64)[None, :, None]
    cols = torch.arange(n_cols, **i64)[None, None, :]
    return _hash_u32(_seed_int(seed), b, rows, cols) < _keep_threshold(rate)


def _seed_int(seed: Seed) -> int:
    return (int(seed.item()) if isinstance(seed, torch.Tensor) else int(seed)) & _M32


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card-side oracle of chip_smoke.py)
# ---------------------------------------------------------------------------


def gatv2_attention_fwd_plain(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
) -> torch.Tensor:
    """K1's function in plain tensor ops: the dense path of ``graph/ops.py``
    on float32 inputs, output in v's type."""
    B, N, E = p.shape
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, N * N * E))
    af = a.float()
    bf = None if bias is None else bias.float()
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        s = gatv2_scores_dense(p[sl].float(), q[sl].float(), af, alpha)
        out[sl] = gat_aggregate_dense(s, v[sl].float(), bf).to(v.dtype)
    return out


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
    v's type), u (B, N, D), m and l (B, N), all but out float32."""
    B, N, E = p.shape
    D = v.shape[-1]
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
    derives through the row sum l."""
    B, N, E = p.shape
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
            fn.argtypes = [ptr] * 6 + [i32] * 5 + [f32, ptr]
            fn.restype = i32
        for fn in (lib.gatv2_fwd_res_f32, lib.gatv2_fwd_res_bf16):
            fn.argtypes = [ptr] * 10 + [i32] * 5 + [f32, ctypes.c_uint32, f32, ptr]
            fn.restype = i32
        lib.gatv2_fwd_smem_bytes.argtypes = [i32]
        lib.gatv2_fwd_smem_bytes.restype = ctypes.c_long
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
        for name in ("dp_da", "dq_dv"):
            for dt in ("f32", "bf16"):
                fn = getattr(lib, f"gatv2_bwd_{name}_{dt}")
                fn.argtypes = [ptr] * 12 + [i32] * 4 + tail
                fn.restype = i32
        for dt in ("f32", "bf16"):
            fn = getattr(lib, f"gatv2_bwd_dbias_{dt}")
            fn.argtypes = [ptr] * 11 + [i32] * 5 + tail
            fn.restype = i32
            fn = getattr(lib, f"gatv2_bwd_graph_{dt}")
            fn.argtypes = [ptr] * 14 + [i32] * 4 + tail
            fn.restype = i32
        lib.gatv2_bwd_smem_bytes.argtypes = [i32] * 4
        lib.gatv2_bwd_smem_bytes.restype = ctypes.c_long
        lib.gatv2_bwd_graph_split.argtypes = []
        lib.gatv2_bwd_graph_split.restype = i32
        lib.gatv2_bwd_graph_row_groups.argtypes = [i32]
        lib.gatv2_bwd_graph_row_groups.restype = i32
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
    memory: "graph" (K2ab, one block holds a batch element's whole graph)
    where the graph fits a block, else "tiled" (K2a then K2b)."""
    if min(N, E, D) < 1:
        raise ValueError(f"gat_bwd_plan: empty graph or width (N {N}, E {E}, D {D})")
    if graph_row_groups(N) and gat_bwd_smem_bytes(N, E, D) <= smem_limit:
        return "graph"
    return "tiled"


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
    block, else "tiled" (16-row tiles streaming the keys)."""
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


def _fwd_variant(name: str, N: int, E: int, D: int, variant: Optional[str]) -> Tuple[str, int]:
    """(variant, row_blocks argument) of a forward launch: the planned
    variant, or the one the caller forces; 0 row blocks is the tiled kernel."""
    variant = variant or gat_fwd_plan(N, E, D)
    if variant == "graph":
        return variant, _check_fwd_layout(N, E, D)
    if variant != "tiled":
        raise ValueError(f"{name}: variant {variant!r} is neither 'graph' nor 'tiled'")
    if _fwd_lib().gatv2_fwd_smem_bytes(D) > _SMEM_LIMIT:
        raise ValueError(f"{name}: value width {D} needs more shared memory than a block has")
    return variant, 0


def _count_fwd(fn, variant: str, row_blocks: int) -> None:
    fn.launches += 1
    fn.launches_by_variant[variant] += 1
    fn.last_launch = {"variant": variant, "row_blocks": row_blocks}


def _check(name: str, p, q, a, bias, v) -> None:
    """Device, type and shape checks of a CUDA launch."""
    if p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {p.device}")
    B, N, E = p.shape
    if q.shape != p.shape or v.shape[:2] != (B, N) or a.shape != (E,):
        raise ValueError(
            f"{name}: shapes p {tuple(p.shape)} q {tuple(q.shape)} "
            f"a {tuple(a.shape)} v {tuple(v.shape)} do not agree")
    if bias is not None and bias.shape != (N, N):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not ({N}, {N})")
    if p.dtype not in (torch.float32, torch.bfloat16) or any(
        t.dtype != p.dtype for t in (q, a, v)
    ):
        raise TypeError(f"{name}: p, q, a and v must all be float32 or all bfloat16")
    tensors = (q, a, v) + (() if bias is None else (bias,))
    if any(t.device != p.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if E == 0:
        raise ValueError(f"{name}: empty embedding")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _drop_args(seed: Seed, rate: float, device):
    """(seed tensor or None, keep threshold, scale) of a launch."""
    if rate <= 0.0:
        return None, 0, 1.0
    if not isinstance(seed, torch.Tensor):
        # a fill kernel carries the value: no host-to-device copy
        seed = torch.full((1,), _seed_int(seed), dtype=torch.int64, device=device)
    elif seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != device:
        raise ValueError("the dropout seed must be one int64 value on the "
                         "device of the inputs")
    return seed, _keep_threshold(rate), 1.0 / (1.0 - rate)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def gatv2_attention_fwd(
    p: torch.Tensor,                 # (B, N, E) query-side projection
    q: torch.Tensor,                 # (B, N, E) key-side projection + lin bias
    a: torch.Tensor,                 # (E,) attention vector
    bias: Optional[torch.Tensor],    # (N, N) score bias, or None
    v: torch.Tensor,                 # (B, N, D) node values
    alpha: float,                    # leaky-relu negative slope
    variant: Optional[str] = None,   # "graph" or "tiled"; None: gat_fwd_plan's
) -> torch.Tensor:
    """Fused GATv2 attention forward (K1), (B, N, D) in v's type, without
    gradient: a CPU tensor takes the plain version and a CUDA tensor
    launches K1 or raises, in the variant ``gat_fwd_plan`` names for the
    shape unless ``variant`` forces one, recorded in ``last_launch``. K1 has
    no backward, so a call that autograd would record raises on both
    devices; ``gatv2_attention`` is the differentiable call."""
    if _needs_grad(p, q, a, bias, v):
        raise RuntimeError("gatv2_attention_fwd (K1) records no gradient; call "
                           "gatv2_attention, which trains through K1-res and K2")
    if p.device.type == "cpu":
        return gatv2_attention_fwd_plain(p, q, a, bias, v, alpha)
    _check("gatv2_attention_fwd", p, q, a, bias, v)
    B, N, E = p.shape
    D = v.shape[-1]
    out = torch.empty((B, N, D), dtype=p.dtype, device=p.device)
    if B == 0 or N == 0 or D == 0:
        return out
    variant, row_blocks = _fwd_variant("gatv2_attention_fwd", N, E, D, variant)
    lib = _fwd_lib()
    p, q, a, v = (t.contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.to(torch.float32).contiguous()
    fn = lib.gatv2_fwd_f32 if p.dtype == torch.float32 else lib.gatv2_fwd_bf16
    with torch.cuda.device(p.device):
        err = fn(_ptr(p), _ptr(q), _ptr(a), _ptr(bias_c), _ptr(v), _ptr(out),
                 B, N, E, D, row_blocks, float(alpha), _stream(p.device))
    _raise_on(err, f"gatv2_fwd {variant}")
    _count_fwd(gatv2_attention_fwd, variant, row_blocks)
    return out


gatv2_attention_fwd.launches = 0
gatv2_attention_fwd.launches_by_variant = {"graph": 0, "tiled": 0}
gatv2_attention_fwd.last_launch = None


def gatv2_attention_res(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
    seed: Seed = 0, rate: float = 0.0, variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1-res: (out (B, N, D) in v's type, u (B, N, D), m (B, N), l (B, N)
    float32), with attention dropout at ``rate`` keyed by ``seed``; the
    variant as ``gatv2_attention_fwd`` chooses it. Records no autograd
    history; ``gatv2_attention`` is the differentiable call."""
    if p.device.type == "cpu":
        return gatv2_attention_res_plain(p, q, a, bias, v, alpha, seed, rate)
    _check("gatv2_attention_res", p, q, a, bias, v)
    B, N, E = p.shape
    D = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=p.device)
    out = torch.empty((B, N, D), dtype=p.dtype, device=p.device)
    u, m, l = torch.empty((B, N, D), **f32), torch.empty((B, N), **f32), torch.empty((B, N), **f32)
    if B == 0 or N == 0 or D == 0:
        return out, u, m, l
    variant, row_blocks = _fwd_variant("gatv2_attention_res", N, E, D, variant)
    lib = _fwd_lib()
    p, q, a, v = (t.detach().contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.detach().to(torch.float32).contiguous()
    seed_t, thresh, scale = _drop_args(seed, rate, p.device)
    fn = lib.gatv2_fwd_res_f32 if p.dtype == torch.float32 else lib.gatv2_fwd_res_bf16
    with torch.cuda.device(p.device):
        err = fn(_ptr(p), _ptr(q), _ptr(a), _ptr(bias_c), _ptr(v), _ptr(out),
                 _ptr(u), _ptr(m), _ptr(l), _ptr(seed_t), B, N, E, D, row_blocks,
                 float(alpha), thresh, scale, _stream(p.device))
    _raise_on(err, f"gatv2_fwd_res {variant}")
    _count_fwd(gatv2_attention_res, variant, row_blocks)
    return out, u, m, l


gatv2_attention_res.launches = 0
gatv2_attention_res.launches_by_variant = {"graph": 0, "tiled": 0}
gatv2_attention_res.last_launch = None


def _bwd_launch(which: int, name: str, p, q, a, bias, v, m, l, du, dvec,
                alpha, seed, rate, outs, extra=()):
    """Launch K2a (0), K2b (1), K2c (2) or K2ab (3) writing into ``outs``;
    the caller has run ``_check``."""
    B, N, E = p.shape
    D = v.shape[-1]
    lib = _bwd_lib()
    if lib.gatv2_bwd_smem_bytes(which, N, E, D) > _SMEM_LIMIT:
        raise ValueError(f"{name}: widths E {E}, D {D} need more shared memory "
                         "than a block has")
    p, q, a, v = (t.detach().contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.detach().to(torch.float32).contiguous()
    m, l, du, dvec = (t.detach().to(torch.float32).contiguous() for t in (m, l, du, dvec))
    seed_t, thresh, scale = _drop_args(seed, rate, p.device)
    kind = ("dp_da", "dq_dv", "dbias", "graph")[which]
    dt = "f32" if p.dtype == torch.float32 else "bf16"
    fn = getattr(lib, f"gatv2_bwd_{kind}_{dt}")
    with torch.cuda.device(p.device):
        err = fn(_ptr(p), _ptr(q), _ptr(a), _ptr(bias_c), _ptr(v), _ptr(seed_t),
                 _ptr(m), _ptr(l), _ptr(du), _ptr(dvec), *(_ptr(t) for t in outs),
                 B, N, E, D, *extra, float(alpha), thresh, scale, _stream(p.device))
    _raise_on(err, f"gatv2_bwd_{kind}")


def gatv2_bwd_dp_da(p, q, a, bias, v, m, l, du, dvec, alpha: float,
                    seed: Seed = 0, rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2a on CUDA tensors: dp (B, N, E) in p's type and da (E,) float32,
    from the forward's row stats m, l (B, N), du = g . out (1 - out)
    (B, N, D) and dvec = sum_d du . u (B, N). The CPU computes all of K2a-c
    in one call of ``gatv2_attention_bwd_plain``."""
    _check("gatv2_bwd_dp_da", p, q, a, bias, v)
    B, N, E = p.shape
    dp = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    da_part = torch.empty((B * -(-N // _BI), E), dtype=torch.float32, device=p.device)
    if B == 0 or N == 0:
        return dp, torch.zeros((E,), dtype=torch.float32, device=p.device)
    _bwd_launch(0, "gatv2_bwd_dp_da", p, q, a, bias, v, m, l, du, dvec, alpha, seed,
                rate, (dp, da_part))
    gatv2_bwd_dp_da.launches += 1
    return dp, da_part.sum(dim=0)


gatv2_bwd_dp_da.launches = 0


def gatv2_bwd_dq_dv(p, q, a, bias, v, m, l, du, dvec, alpha: float,
                    seed: Seed = 0, rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b on CUDA tensors: dq (B, N, E) in q's type and dv (B, N, D) in
    v's type; inputs as ``gatv2_bwd_dp_da``."""
    _check("gatv2_bwd_dq_dv", p, q, a, bias, v)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if p.shape[0] == 0 or p.shape[1] == 0:
        return dq, dv
    _bwd_launch(1, "gatv2_bwd_dq_dv", p, q, a, bias, v, m, l, du, dvec, alpha, seed,
                rate, (dq, dv))
    gatv2_bwd_dq_dv.launches += 1
    return dq, dv


gatv2_bwd_dq_dv.launches = 0


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


def gatv2_bwd_graph(p, q, a, bias, v, m, l, du, dvec, alpha: float, seed: Seed = 0,
                    rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """K2ab on CUDA tensors: K2a's and K2b's outputs (dp, dq, da, dv) in one
    launch, one block per batch element holding its whole graph; inputs as
    ``gatv2_bwd_dp_da``. Raises where ``gat_bwd_plan`` names "tiled"."""
    _check("gatv2_bwd_graph", p, q, a, bias, v)
    B, N, E = p.shape
    D = v.shape[-1]
    dp = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if B == 0 or N == 0:
        return dp, dq, torch.zeros((E,), dtype=torch.float32, device=p.device), dv
    _check_graph_layout(N, E, D)
    da_part = torch.empty((B, E), dtype=torch.float32, device=p.device)
    _bwd_launch(3, "gatv2_bwd_graph", p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate,
                (dp, dq, dv, da_part))
    gatv2_bwd_graph.launches += 1
    return dp, dq, da_part.sum(dim=0), dv


gatv2_bwd_graph.launches = 0


def gatv2_bwd(p, q, a, bias, v, m, l, du, dvec, alpha: float, seed: Seed = 0,
              rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """The attention backward but dbias, on CUDA tensors: (dp, dq, da, dv)
    through the variant ``gat_bwd_plan`` names for the shape, K2ab alone
    ("graph") or K2a then K2b ("tiled"), recorded in
    ``gatv2_bwd.last_launch``."""
    _, N, E = p.shape
    variant = gat_bwd_plan(max(N, 1), E, max(v.shape[-1], 1))
    args = (p, q, a, bias, v, m, l, du, dvec, alpha, seed, rate)
    if variant == "graph":
        out = gatv2_bwd_graph(*args)
    else:
        dp, da = gatv2_bwd_dp_da(*args)
        dq, dv = gatv2_bwd_dq_dv(*args)
        out = (dp, dq, da, dv)
    gatv2_bwd.last_launch = {"variant": variant}
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


def gatv2_bwd_dbias(p, q, a, bias, v, m, l, du, dvec, alpha: float,
                    seed: Seed = 0, rate: float = 0.0) -> torch.Tensor:
    """K2c on CUDA tensors: dbias (N, N) float32 = sum over the batch of
    ds; inputs as ``gatv2_bwd_dp_da``, bias not None."""
    if bias is None:
        raise ValueError("gatv2_bwd_dbias: the call has no bias")
    _check("gatv2_bwd_dbias", p, q, a, bias, v)
    B, N, _ = p.shape
    if B == 0 or N == 0:
        return torch.zeros((N, N), dtype=torch.float32, device=p.device)
    n_chunks = dbias_chunks(B, N, _build.sm_count(p.device))
    part = torch.empty((n_chunks, N, N), dtype=torch.float32, device=p.device)
    _bwd_launch(2, "gatv2_bwd_dbias", p, q, a, bias, v, m, l, du, dvec, alpha, seed,
                rate, (part,), (n_chunks,))
    gatv2_bwd_dbias.launches += 1
    return part[0] if n_chunks == 1 else part.sum(dim=0)


gatv2_bwd_dbias.launches = 0


# ---------------------------------------------------------------------------
# The differentiable call: mtad_gat_tpu/kernels/gat_pallas.py::_fused
# (custom VJP, :752-778).
# ---------------------------------------------------------------------------


class _GATv2Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, q, a, bias, v, alpha, seed, rate):
        out, u, m, l = gatv2_attention_res(p, q, a, bias, v, alpha, seed, rate)
        ctx.save_for_backward(p, q, a, bias, v, u, m, l,
                              seed if isinstance(seed, torch.Tensor) else None)
        ctx.alpha, ctx.rate = alpha, rate
        ctx.seed = None if isinstance(seed, torch.Tensor) else seed
        return out

    @staticmethod
    def backward(ctx, g):
        p, q, a, bias, v, u, m, l, seed_t = ctx.saved_tensors
        args = (ctx.alpha, seed_t if seed_t is not None else ctx.seed, ctx.rate)
        # outside the kernels, as _fused_backward computes them (:610-612)
        out = torch.sigmoid(u)
        du = g.float() * out * (1.0 - out)
        if p.device.type == "cpu":
            dp, dq, da, dbias, dv = gatv2_attention_bwd_plain(p, q, a, bias, v, du, *args)
        else:
            dvec = (du * u).sum(dim=-1)
            dp, dq, da, dv = gatv2_bwd(p, q, a, bias, v, m, l, du, dvec, *args)
            dbias = None
            if bias is not None and ctx.needs_input_grad[3]:
                dbias = gatv2_bwd_dbias(p, q, a, bias, v, m, l, du, dvec, *args)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return (dp.to(p.dtype), dq.to(q.dtype), da.to(a.dtype), dbias, dv.to(v.dtype),
                None, None, None)


def gatv2_attention(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
    seed: Seed = 0, rate: float = 0.0,
) -> torch.Tensor:
    """Fused GATv2 attention with gradients and attention dropout at
    ``rate`` (0 in eval), keyed by ``seed`` (an int, or one int64 value on
    the inputs' device). Where a gradient is needed, or dropout is on, it
    runs K1-res forward (and K2a-c backward); otherwise K1 alone."""
    if rate > 0.0 or _needs_grad(p, q, a, bias, v):
        return _GATv2Attention.apply(p, q, a, bias, v, alpha, seed, rate)
    return gatv2_attention_fwd(p, q, a, bias, v, alpha)
