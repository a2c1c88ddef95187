"""SAME 3x3x3 convolution: the Hopper implicit-GEMM kernel, its wrapper, its
plain version and the autograd Function that joins them.

Counterpart of `jointimagegeneration_tpu/ops/pallas/conv3d.py`
(`conv3d_3x3`, `conv3d_3x3_v2`) and the kernel under
`ops/pallas/fused_resblock.py` (see `ops/fused_resblock.py` here).  One CUDA
kernel, `csrc/conv3d.cu`, computes all three TPU kernels' function:

    out = cast(act(conv3x3x3(t(x), kernel) + bias + residual)),  t(x) = x or
    round(silu(x * scale + shift)) on in-bounds taps (0 on the padding),

with fp32 accumulation, plus optional per-channel [sum, sum of squares]
(2, Cout) fp32 of the value before the cast.  Layout is the JAX package's:
channels-last x (B, D, H, W, Cin) and a DHWIO kernel (3, 3, 3, Cin, Cout).

On CPU tensors every wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises.  The backward of every Function recomputes
through the plain version, as the JAX package's custom VJPs recompute through
XLA (`_conv3d_bwd`, `_v2_bwd`, `_bwd_a`, `_bwd_b`); none has a backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .cuda.build import load_library

__all__ = ["CONV3D_SOURCE", "conv3d_plain", "conv3d_igemm", "channel_stats_reduce", "conv3d_fused",
           "conv3d_3x3", "conv3d_3x3_v2", "conv_flops"]

CONV3D_SOURCE = "conv3d"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_AFFINE, _BIAS, _RESIDUAL, _STATS, _ACTIVATE = 1, 2, 4, 8, 16
_BLOCK_M = 64  # output voxels per block of the kernel: rows of its stats partials

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def conv_flops(x_shape, cout: int) -> float:
    """Multiply-adds x 2 of one SAME 3x3x3 conv of a (B, D, H, W, Cin) input."""
    b, d, h, w, cin = x_shape
    return 2.0 * b * d * h * w * 27 * cin * cout


def conv3d_plain(x: torch.Tensor, kernel: torch.Tensor, scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None, want_stats: bool = False,
                 activate: bool = False) -> Out:
    """Plain PyTorch version of the kernel, step for step as the JAX package's
    `_xla_reference` (fused_resblock.py:187-207) and `_xla_conv3d`:

    * with `scale`/`shift`: t = silu(x * scale + shift) in fp32, cast to x's
      dtype (F.conv3d's zero padding is the kernel's pad re-zeroing);
    * the kernel is cast to x's dtype; both operands are then upcast to fp32
      (exactly) and convolved in fp32, one accumulator and one final cast, as
      `preferred_element_type=float32` does.  On the card this relies on
      cuDNN's TF32 being off (`core.runtime.configure_precision`);
    * + bias (fp32), + residual (as fp32); stats [sum, sumsq] of that fp32
      value; `activate` applies SiLU to it; the result is cast to x's dtype.
    """
    if scale is not None:
        t = F.silu(x.float() * scale.float() + shift.float()).to(x.dtype)
    else:
        t = x
    y = F.conv3d(t.float().movedim(-1, 1), kernel.to(x.dtype).float().permute(4, 3, 0, 1, 2),
                 padding=1).movedim(1, -1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    stats = None
    if want_stats:
        flat = y.reshape(-1, y.shape[-1])
        stats = torch.stack([flat.sum(dim=0), (flat * flat).sum(dim=0)])
    if activate:
        y = F.silu(y)
    out = y.to(x.dtype).contiguous()
    return (out, stats) if want_stats else out


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """A C entry point of csrc/conv3d.cu, built on first use."""
    fn = getattr(load_library(CONV3D_SOURCE), name)
    if name == "jig_conv3d":
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, kernel: torch.Tensor, scale, shift, bias, residual, who: str) -> None:
    if x.ndim != 5 or kernel.ndim != 5 or tuple(kernel.shape[:4]) != (3, 3, 3, x.shape[-1]):
        raise ValueError(f"{who} wants x (B, D, H, W, Cin) and a (3, 3, 3, Cin, Cout) kernel, got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{who} takes bf16 or fp32 x, got {x.dtype}")
    cin, cout = x.shape[-1], kernel.shape[-1]
    if min(x.shape) < 1 or cout < 1:
        raise ValueError(f"{who}: empty shape {tuple(x.shape)} -> {cout}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{who}: scale and shift come together")
    for name, t, n in (("scale", scale, cin), ("shift", shift, cin), ("bias", bias, cout)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{who}: {name} must be ({n},), got {tuple(t.shape)}")
    if residual is not None and tuple(residual.shape) != (*x.shape[:4], cout):
        raise ValueError(f"{who}: residual must be {(*x.shape[:4], cout)}, got {tuple(residual.shape)}")
    devices = {t.device for t in (x, kernel, scale, shift, bias, residual) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{who}: all tensors must be on one device, got {devices}")


def _raise_on(err: int, name: str, x: torch.Tensor, cout: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} at x={tuple(x.shape)} "
                           f"-> {cout} {x.dtype}")


def conv3d_igemm(x: torch.Tensor, kernel: torch.Tensor, scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None, want_stats: bool = False,
                 activate: bool = False) -> Out:
    """The conv on the card (CUDA tensors only): launches `csrc/conv3d.cu`'s
    kernel, counted in `conv3d_igemm.launches`; with `want_stats` the
    per-block partial sums then go through `channel_stats_reduce`.

    The kernel takes the weight as its (Cout, 27*Cin) transpose in x's dtype,
    made here per call (`kernel.permute(4, 0, 1, 2, 3)`): one pass over the
    weight, as the unfused path's per-op cast of its fp32 parameters is."""
    who = "conv3d_igemm"
    _check(x, kernel, scale, shift, bias, residual, who)
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")
    if activate and (scale is not None or bias is not None or residual is not None or want_stats):
        raise ValueError(f"{who}: the SiLU epilogue is conv3d_3x3's and comes alone")
    b, d, h, w, cin = x.shape
    cout = kernel.shape[-1]
    if x.numel() >= 2**31 or b * d * h * w * cout >= 2**31 or 27 * cin * cout >= 2**31:
        raise ValueError(f"{who}: tensors too large for 32-bit indexing: {tuple(x.shape)} -> {cout}")
    x = x.contiguous()
    wt = kernel.permute(4, 0, 1, 2, 3).reshape(cout, 27 * cin).to(x.dtype).contiguous()
    f32 = lambda t: None if t is None else t.float().contiguous()
    scale, shift, bias = f32(scale), f32(shift), f32(bias)
    if residual is not None:
        if residual.dtype != x.dtype:
            raise TypeError(f"{who}: the kernel takes the residual in x's dtype {x.dtype}, got {residual.dtype}")
        residual = residual.contiguous()
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    n_blocks = -(-(b * d * h * w) // _BLOCK_M)
    partial = (torch.empty((n_blocks, 2, cout), dtype=torch.float32, device=x.device)
               if want_stats else None)
    flags = ((_AFFINE if scale is not None else 0) | (_BIAS if bias is not None else 0)
             | (_RESIDUAL if residual is not None else 0) | (_STATS if want_stats else 0)
             | (_ACTIVATE if activate else 0))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel_fn("jig_conv3d")(x.data_ptr(), wt.data_ptr(), ptr(scale), ptr(shift), ptr(bias),
                                       ptr(residual), out.data_ptr(), ptr(partial), b, d, h, w, cin, cout,
                                       _DTYPE_CODES[x.dtype], flags, stream)
    _raise_on(err, "conv3d", x, cout)
    conv3d_igemm.launches += 1
    if not want_stats:
        return out
    return out, channel_stats_reduce(partial)


conv3d_igemm.launches = 0


def channel_stats_reduce(partial: torch.Tensor) -> torch.Tensor:
    """(rows, 2, C) fp32 partial sums -> (2, C), summed over rows in a fixed
    order by `csrc/conv3d.cu`'s reduce kernel (CUDA tensors only; counted in
    `channel_stats_reduce.launches`)."""
    if partial.device.type != "cuda" or partial.dtype != torch.float32 or partial.ndim != 3 \
            or partial.shape[1] != 2 or not partial.is_contiguous():
        raise ValueError(f"channel_stats_reduce wants a contiguous (rows, 2, C) fp32 CUDA tensor, got "
                         f"{tuple(partial.shape)} {partial.dtype} on {partial.device}")
    rows, cols = partial.shape[0], 2 * partial.shape[2]
    stats = torch.empty((2, partial.shape[2]), dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream(partial.device).cuda_stream
        err = _kernel_fn("jig_conv3d_stats_reduce")(partial.data_ptr(), stats.data_ptr(), rows, cols, stream)
    if err != 0:
        raise RuntimeError(f"conv3d stats reduce launch failed: cudaError {err} at {tuple(partial.shape)}")
    channel_stats_reduce.launches += 1
    return stats


channel_stats_reduce.launches = 0


def _forward(x, kernel, scale, shift, bias, residual, want_stats, activate) -> Out:
    """The kernel on a CUDA tensor (`conv3d_igemm` checks and raises), the
    plain version on a CPU tensor."""
    if x.device.type != "cpu":
        return conv3d_igemm(x, kernel, scale, shift, bias, residual, want_stats, activate)
    _check(x, kernel, scale, shift, bias, residual, "conv3d")
    return conv3d_plain(x, kernel, scale, shift, bias, residual, want_stats, activate)


class _Conv3d(torch.autograd.Function):
    """The conv's forward through `_forward`; the backward recomputes through
    the plain version (the JAX package's custom VJPs recompute through XLA)."""

    @staticmethod
    def forward(ctx, x, kernel, scale, shift, bias, residual, want_stats, activate):
        ctx.save_for_backward(x, kernel, scale, shift, bias, residual)
        ctx.flags = (want_stats, activate)
        return _forward(x, kernel, scale, shift, bias, residual, want_stats, activate)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        want_stats, activate = ctx.flags
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad[:6])]
        with torch.enable_grad():
            outs = conv3d_plain(*inputs, want_stats=want_stats, activate=activate)
        outs = outs if want_stats else (outs,)
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True) if wrt else ())
        return (*(next(got) if t is not None and t.requires_grad else None for t in inputs), None, None)


def conv3d_fused(x: torch.Tensor, kernel: torch.Tensor, scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None, want_stats: bool = False,
                 activate: bool = False) -> Out:
    """Differentiable conv with every option of the kernel: (out [, stats])."""
    return _Conv3d.apply(x, kernel, scale, shift, bias, residual, want_stats, activate)


def _conv3d_3x3(x: torch.Tensor, kernel: torch.Tensor, tile_h: int, activate: bool, who: str) -> torch.Tensor:
    if x.ndim == 5 and x.shape[2] % tile_h:
        raise ValueError(f"{who}: H ({x.shape[2]}) must be a multiple of tile_h ({tile_h})")
    return conv3d_fused(x, kernel.to(x.dtype), activate=activate)


def conv3d_3x3(x: torch.Tensor, kernel: torch.Tensor, tile_h: int = 8, activate: bool = False) -> torch.Tensor:
    """'SAME' 3x3x3 conv (+ optional fused SiLU) of (B, D, H, W, Cin) with a
    (3, 3, 3, Cin, Cout) kernel; the counterpart of `conv3d_3x3`
    (conv3d.py:87-96).  `tile_h` is the TPU kernel's row tile, kept for its
    check: H % tile_h != 0 raises, as there.  Any batch."""
    return _conv3d_3x3(x, kernel, tile_h, activate, "conv3d_3x3")


def conv3d_3x3_v2(x: torch.Tensor, kernel: torch.Tensor, tile_h: int = 8, activate: bool = False) -> torch.Tensor:
    """The counterpart of `conv3d_3x3_v2` (conv3d.py:180-183): the same
    function as `conv3d_3x3`, so the same kernel."""
    return _conv3d_3x3(x, kernel, tile_h, activate, "conv3d_3x3_v2")
