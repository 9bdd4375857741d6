"""Fused GATv2 attention forward: the CUDA kernel ``csrc/gat_fwd.cu`` and
its plain PyTorch version.

Replaces ``mtad_gat_tpu/kernels/gat_pallas.py::_kernel`` (the forward of
``gatv2_attention_fused``, launched by ``_fused_forward``) on the scoring
path, where dropout is off. For each destination node i of a complete graph:

    out_i = sigmoid( sum_j softmax_j( a . leakyrelu(p_i + q_j) + bias_ij ) v_j )

What bounds it on the card: the score is float32 work on the CUDA cores
(about 4 operations per (i, j, e), no product structure for the tensor
cores), and at the model's graph sizes that work and the bytes of p, q and
v are of the same order. The kernel computes it as an online softmax over
key tiles with every operand of the inner loop in shared memory, so no
(N, N) tensor is written to device memory (``csrc/gat_fwd.cu`` says more).
The TPU kernel's VMEM tiling plan (``_Plan``) and its lane padding are not
carried over: the CUDA kernel picks its own tiles and masks ragged edges.

In-kernel attention dropout, the residual outputs and the backward kernels
come with the training slice (ROADMAP.md, Queue 2: K1-res, K2a-c).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mtad_gat_tpu_torch.graph.ops import gat_aggregate_dense, gatv2_scores_dense
from mtad_gat_tpu_torch.kernels import _build

# Largest (batch chunk x N x N x E) float32 temporary the plain version
# builds at once, to bound its memory at large batches.
_PLAIN_CHUNK_ELEMS = 1 << 26
_SMEM_LIMIT = 227 * 1024


def gatv2_attention_fwd_plain(
    p: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
    bias: Optional[torch.Tensor], v: torch.Tensor, alpha: float,
) -> torch.Tensor:
    """The kernel's function in plain tensor ops: the dense path of
    ``graph/ops.py`` on float32 inputs, output in v's type."""
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("gat_fwd")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.gatv2_fwd_f32, lib.gatv2_fwd_bf16):
            fn.argtypes = [ptr] * 6 + [i32] * 4 + [ctypes.c_float, ptr]
            fn.restype = i32
        lib.gatv2_fwd_smem_bytes.argtypes = [i32]
        lib.gatv2_fwd_smem_bytes.restype = ctypes.c_long
        lib._typed = True
    return lib


def gatv2_attention_fwd(
    p: torch.Tensor,                 # (B, N, E) query-side projection
    q: torch.Tensor,                 # (B, N, E) key-side projection + lin bias
    a: torch.Tensor,                 # (E,) attention vector
    bias: Optional[torch.Tensor],    # (N, N) score bias, or None
    v: torch.Tensor,                 # (B, N, D) node values
    alpha: float,                    # leaky-relu negative slope
) -> torch.Tensor:
    """Fused GATv2 attention forward, (B, N, D) in v's type. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if p.device.type == "cpu":
        return gatv2_attention_fwd_plain(p, q, a, bias, v, alpha)
    if p.device.type != "cuda":
        raise ValueError(f"gatv2_attention_fwd: unsupported device {p.device}")
    B, N, E = p.shape
    D = v.shape[-1]
    if q.shape != p.shape or v.shape[:2] != (B, N) or a.shape != (E,):
        raise ValueError(
            f"gatv2_attention_fwd: shapes p {tuple(p.shape)} q {tuple(q.shape)} "
            f"a {tuple(a.shape)} v {tuple(v.shape)} do not agree")
    if bias is not None and bias.shape != (N, N):
        raise ValueError(f"gatv2_attention_fwd: bias {tuple(bias.shape)} is not ({N}, {N})")
    dtype = p.dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
        t.dtype != dtype for t in (q, a, v)
    ):
        raise TypeError("gatv2_attention_fwd: p, q, a and v must all be "
                        "float32 or all bfloat16")
    tensors = (q, a, v) + (() if bias is None else (bias,))
    if any(t.device != p.device for t in tensors):
        raise ValueError("gatv2_attention_fwd: all tensors must be on one device")
    out = torch.empty((B, N, D), dtype=dtype, device=p.device)
    if B == 0 or N == 0 or D == 0:
        return out
    if E == 0:
        raise ValueError("gatv2_attention_fwd: empty embedding")
    lib = _lib()
    if lib.gatv2_fwd_smem_bytes(D) > _SMEM_LIMIT:
        raise ValueError(f"gatv2_attention_fwd: value width {D} needs more "
                         "shared memory than a block has")
    p, q, a, v = (t.contiguous() for t in (p, q, a, v))
    bias_c = None if bias is None else bias.to(torch.float32).contiguous()
    fn = lib.gatv2_fwd_f32 if dtype == torch.float32 else lib.gatv2_fwd_bf16
    with torch.cuda.device(p.device):
        err = fn(
            p.data_ptr(), q.data_ptr(), a.data_ptr(),
            None if bias_c is None else bias_c.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, N, E, D, float(alpha),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gatv2_fwd kernel launch failed: CUDA error {err}")
    gatv2_attention_fwd.launches += 1
    return out


gatv2_attention_fwd.launches = 0
