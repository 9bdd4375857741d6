"""Fused GRU scan forward: the CUDA kernel ``csrc/gru_fwd.cu`` and its plain
PyTorch version.

Replaces ``mtad_gat_tpu/kernels/gru_pallas.py::_gru_fwd_kernel`` (the
forward of ``gru_scan_fused``, launched by ``_fwd_launch``): the whole
recurrence in one launch, torch's cell

    r = sigmoid(gi_r + h W_hr + b_hr)
    z = sigmoid(gi_z + h W_hz + b_hz)
    n = tanh(gi_n + r * (h W_hn + b_hn))
    h' = (1 - z) n + z h

with ``gi = x W_ih + b_ih`` computed by the caller (``nn/gru.py``).

What bounds it on the card: the steps are serial, so a step's latency sets
the time, not the card's throughput. Each block keeps its batch rows' hidden
state in shared memory through all steps and reads W_hh (270 KB at hidden
150, more than a block's 227 KB of shared memory) from L2 on every step
(``csrc/gru_fwd.cu`` says more). The TPU kernel's 128-lane and 8-row padding
is not carried over: the CUDA kernel masks its ragged batch tile.

The backward (BPTT) kernel, K4, is still to be ported (ROADMAP.md, Queue
2): until then the scan refuses to run where autograd would record it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mtad_gat_tpu_torch.kernels import _build

_SMEM_LIMIT = 227 * 1024


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
    (hseq (B, T, H) float32, h_last (B, H))."""
    B, T, _ = gi.shape
    w, b = w_hh.float(), b_hh.float()
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
            fn.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
            fn.restype = i32
        lib.gru_fwd_smem_bytes.argtypes = [i32]
        lib.gru_fwd_smem_bytes.restype = ctypes.c_long
        lib._typed = True
    return lib


def gru_scan_fwd(
    gi: torch.Tensor,      # (B, T, 3H): precomputed x @ W_ih + b_ih
    w_hh: torch.Tensor,    # (H, 3H), gate order (r, z, n)
    b_hh: torch.Tensor,    # (3H,)
    hid_dim: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the GRU recurrence in one launch. Returns (hseq (B, T, H)
    float32, h_last (B, H)). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises. Where autograd would record the
    call it raises on both: the kernel has no backward yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gi, w_hh, b_hh)):
        raise NotImplementedError(
            "gru_scan_fwd has no backward until K4, the GRU BPTT kernel, is "
            "ported (ROADMAP.md, Queue 2): train with gru_impl='xla', or run "
            "the scan under torch.no_grad()")
    if gi.device.type == "cpu":
        return gru_scan_fwd_plain(gi, w_hh, b_hh, hid_dim)
    if gi.device.type != "cuda":
        raise ValueError(f"gru_scan_fwd: unsupported device {gi.device}")
    B, T, G = gi.shape
    H = hid_dim
    if G != 3 * H or w_hh.shape != (H, 3 * H) or b_hh.shape != (3 * H,):
        raise ValueError(
            f"gru_scan_fwd: shapes gi {tuple(gi.shape)} w_hh {tuple(w_hh.shape)} "
            f"b_hh {tuple(b_hh.shape)} do not fit hidden width {H}")
    if gi.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("gru_scan_fwd: gi must be float32 or bfloat16")
    if w_hh.device != gi.device or b_hh.device != gi.device:
        raise ValueError("gru_scan_fwd: all tensors must be on one device")
    if T == 0 or H == 0:
        raise ValueError("gru_scan_fwd: empty sequence or hidden state")
    hseq = torch.empty((B, T, H), dtype=torch.float32, device=gi.device)
    if B == 0:
        return hseq, hseq[:, -1, :]
    lib = _lib()
    if lib.gru_fwd_smem_bytes(H) > _SMEM_LIMIT:
        raise ValueError(f"gru_scan_fwd: hidden width {H} needs more shared "
                         "memory than a block has")
    gi = gi.contiguous()
    w = w_hh.to(torch.float32).contiguous()
    b = b_hh.to(torch.float32).contiguous()
    fn = lib.gru_fwd_f32 if gi.dtype == torch.float32 else lib.gru_fwd_bf16
    with torch.cuda.device(gi.device):
        err = fn(
            gi.data_ptr(), w.data_ptr(), b.data_ptr(), hseq.data_ptr(), B, T, H,
            torch.cuda.current_stream(gi.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_fwd kernel launch failed: CUDA error {err}")
    gru_scan_fwd.launches += 1
    return hseq, hseq[:, -1, :]


gru_scan_fwd.launches = 0
