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
the time, not the card's throughput. Each block keeps its batch rows' hidden
state (forward) or gradient carry (backward) in shared memory through all
steps and reads W_hh (270 KB at hidden 150, more than a block's 227 KB of
shared memory) from L2 on every step. The backward recomputes the gates
from the saved states in the same loop that carries the gradient, and forms
dW_hh and db_hh off the serial chain, through partial sums added in a fixed
order (``csrc/gru_bwd.cu`` says more). The TPU kernels' 128-lane and 8-row
padding is not carried over: the CUDA kernels mask their ragged batch tile.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

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
    """K3: run the GRU recurrence in one launch. Returns (hseq (B, T, H)
    float32, h_last (B, H)). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises. It has no backward of its own:
    where autograd would record the call it raises, and ``gru_scan`` is the
    differentiable call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gi, w_hh, b_hh)):
        raise RuntimeError(
            "gru_scan_fwd launches the forward kernel alone and records no "
            "gradient: call gru_scan, or run it under torch.no_grad()")
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


# ---------------------------------------------------------------------------
# K4: the backward through time, mtad_gat_tpu/kernels/gru_pallas.py:74-137
# ---------------------------------------------------------------------------


def gru_scan_bwd_plain(
    gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
    hseq: torch.Tensor, dhseq: torch.Tensor, hid_dim: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function step by step in plain tensor ops, in
    float32: from the saved states hseq (B, T, H) and the cotangent dhseq
    (B, T, H), returns (dgi (B, T, 3H), dw_hh (H, 3H), db_hh (3H,))."""
    B, T, _ = gi.shape
    H = hid_dim
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


def weight_grad_chunks(rows: int, hid_dim: int, sms: int) -> int:
    """Row chunks of K4's dW_hh product on a card of ``sms``
    multiprocessors: its (H, 3H) output alone gives few 64 x 64 tiles, so
    the B * T rows are split until there are about two blocks per
    multiprocessor, each chunk at least one 16-row stage."""
    tiles = -(-hid_dim // 64) * -(-3 * hid_dim // 64)
    return max(1, min(-(-rows // 16), -(-2 * sms // tiles)))


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("gru_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.gru_bwd_scan_f32, lib.gru_bwd_scan_bf16):
            fn.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
            fn.restype = i32
        lib.gru_bwd_weights.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.gru_bwd_weights.restype = i32
        lib.gru_bwd_smem_bytes.argtypes = [i32]
        lib.gru_bwd_smem_bytes.restype = ctypes.c_long
        lib._typed = True
    return lib


def gru_scan_bwd(
    gi: torch.Tensor,      # (B, T, 3H), float32 or bfloat16
    w_hh: torch.Tensor,    # (H, 3H)
    b_hh: torch.Tensor,    # (3H,)
    hseq: torch.Tensor,    # (B, T, H) float32, the forward's output
    dhseq: torch.Tensor,   # (B, T, H), any strides
    hid_dim: int,
    need_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K4 on CUDA tensors: (dgi (B, T, 3H) float32, dw_hh (H, 3H), db_hh
    (3H,)), the last two None when ``need_weights`` is off and only the
    scan runs. The CPU computes the same in ``gru_scan_bwd_plain``."""
    if gi.device.type != "cuda":
        raise ValueError(f"gru_scan_bwd: unsupported device {gi.device}")
    B, T, G = gi.shape
    H = hid_dim
    if (G != 3 * H or w_hh.shape != (H, 3 * H) or b_hh.shape != (3 * H,)
            or hseq.shape != (B, T, H) or dhseq.shape != (B, T, H)):
        raise ValueError(
            f"gru_scan_bwd: shapes gi {tuple(gi.shape)} w_hh {tuple(w_hh.shape)} "
            f"b_hh {tuple(b_hh.shape)} hseq {tuple(hseq.shape)} dhseq "
            f"{tuple(dhseq.shape)} do not fit hidden width {H}")
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
        return dgi, torch.zeros((H, 3 * H), device=dev), torch.zeros((3 * H,), device=dev)
    lib = _bwd_lib()
    if lib.gru_bwd_smem_bytes(H) > _SMEM_LIMIT:
        raise ValueError(f"gru_scan_bwd: hidden width {H} needs more shared "
                         "memory than a block has")
    gi = gi.detach().contiguous()
    w = w_hh.detach().to(torch.float32).contiguous()
    # a second, transposed copy (a layout, not arithmetic) so that both of
    # the scan's products read W_hh along its rows; free when w_hh is the
    # transposed view of an nn.GRU-layout parameter
    w_t = w_hh.detach().to(torch.float32).t().contiguous()
    b = b_hh.detach().to(torch.float32).contiguous()
    hseq = hseq.detach().to(torch.float32).contiguous()
    dhseq = dhseq.detach().to(torch.float32).contiguous()
    dghn = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scan = lib.gru_bwd_scan_f32 if gi.dtype == torch.float32 else lib.gru_bwd_scan_bf16
    with torch.cuda.device(dev):
        err = scan(gi.data_ptr(), w.data_ptr(), w_t.data_ptr(), b.data_ptr(),
                   hseq.data_ptr(), dhseq.data_ptr(), dgi.data_ptr(), dghn.data_ptr(),
                   B, T, H, stream)
        if err != 0:
            raise RuntimeError(f"gru_bwd scan kernel launch failed: CUDA error {err}")
        dw = db = None
        if need_weights:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            S = weight_grad_chunks(B * T, H, sms)
            part = torch.empty((S, H, 3 * H), dtype=torch.float32, device=dev)
            dbpart = torch.empty((S, 3 * H), dtype=torch.float32, device=dev)
            dw = torch.empty((H, 3 * H), dtype=torch.float32, device=dev)
            db = torch.empty((3 * H,), dtype=torch.float32, device=dev)
            err = lib.gru_bwd_weights(hseq.data_ptr(), dgi.data_ptr(), dghn.data_ptr(),
                                      part.data_ptr(), dbpart.data_ptr(), dw.data_ptr(),
                                      db.data_ptr(), B, T, H, S, stream)
            if err != 0:
                raise RuntimeError(
                    f"gru_bwd weights kernel launch failed: CUDA error {err}")
    gru_scan_bwd.launches += 1
    return dgi, dw, db


gru_scan_bwd.launches = 0


# ---------------------------------------------------------------------------
# The differentiable call: mtad_gat_tpu/kernels/gru_pallas.py::_gru_scan
# (custom VJP, :172-249).
# ---------------------------------------------------------------------------


class _GRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gi, w_hh, b_hh, hid_dim):
        hseq, _ = gru_scan_fwd(gi, w_hh, b_hh, hid_dim)   # grad mode is off here
        ctx.save_for_backward(gi, w_hh, b_hh, hseq)
        ctx.hid_dim = hid_dim
        return hseq

    @staticmethod
    @once_differentiable
    def backward(ctx, dhseq):
        gi, w_hh, b_hh, hseq = ctx.saved_tensors
        need_gi, need_w, need_b = ctx.needs_input_grad[:3]
        if gi.device.type == "cpu":
            dgi, dw, db = gru_scan_bwd_plain(gi, w_hh, b_hh, hseq, dhseq, ctx.hid_dim)
        else:
            dgi, dw, db = gru_scan_bwd(gi, w_hh, b_hh, hseq, dhseq, ctx.hid_dim,
                                       need_weights=need_w or need_b)
        return (dgi.to(gi.dtype) if need_gi else None,
                dw.to(w_hh.dtype) if need_w else None,
                db.to(b_hh.dtype) if need_b else None, None)


def gru_scan(
    gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, hid_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused GRU scan with gradients: (hseq (B, T, H) float32, h_last
    (B, H)), arguments as ``gru_scan_fwd``. Forward K3 and backward K4 on
    CUDA tensors, their plain versions on CPU tensors; the backward is not
    itself differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gi, w_hh, b_hh)):
        hseq = _GRUScan.apply(gi, w_hh, b_hh, hid_dim)
        return hseq, hseq[:, -1, :]
    return gru_scan_fwd(gi, w_hh, b_hh, hid_dim)
