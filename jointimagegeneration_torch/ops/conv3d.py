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
launches the kernel or raises.  How a call runs on the card (block tile,
block width, pipeline depth, K split, buffer sizes, launches) is decided on
the host by `plan_conv3d`, a pure function of the shapes that the CPU tests
check and `chip_smoke.py` takes its expected launch counts from.  The backward of every Function recomputes
through the plain version, as the JAX package's custom VJPs recompute through
XLA (`_conv3d_bwd`, `_v2_bwd`, `_bwd_a`, `_bwd_b`); none has a backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .cuda.build import load_library

__all__ = ["CONV3D_SOURCE", "ConvPlan", "plan_conv3d", "conv3d_plain", "conv3d_igemm", "channel_stats_reduce", "conv3d_fused", "conv3d_3x3", "conv3d_3x3_v2", "conv_flops"]

CONV3D_SOURCE = "conv3d"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_AFFINE, _BIAS, _RESIDUAL, _STATS, _ACTIVATE = 1, 2, 4, 8, 16

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]

# The card the plans are made for (H100 SXM) and the kernel's fixed shapes;
# csrc/conv3d.cu holds the same numbers and checks the shared memory size.
SMS = 132
SMEM_LIMIT = 232_448     # bytes of shared memory one block may use (227 KB)
CHUNK = 64               # input channels per halo chunk (bf16)
TILE_YX = (8, 8)         # output rows and columns of a block; its depth is 2 or 4 planes
DEEP_WAVES = 4           # 64-wide bf16 blocks take 4 planes where they make this many waves at one per SM
MIN_SPLIT_ITERS = 2      # (chunk, tap group) iterations a K split keeps at least
F32_CHUNK = 16           # input channels per halo chunk (fp32)
F32_TILE = (4, 8, 8)     # an fp32 block's output tile, with 64 channels and 256 threads
# csrc/conv3d.cu's kFSmemBytes: two ring stages of 3 taps x 16 channels x 64, the 16 channel planes of
# the 6 x 10 x 10 halo (rows of 12 floats, planes padded by 4), and its voxel-major staging copy
_F32_SMEM = 4 * (2 * 3 * F32_CHUNK * 64 + F32_CHUNK * (6 * 10 * 12 + 4) + 6 * 10 * 10 * F32_CHUNK)


@dataclass(frozen=True)
class ConvPlan:
    """How one conv call runs on the card (`plan_conv3d`).

    `tile` is the (z, y, x) output tile of a block.  Block (i, j, s) of
    `grid` owns M-tile i (i = ((b * nz + iz) * ny + iy) * nx + ix over the
    tiles of each volume), output channels [j * bn, (j + 1) * bn) and K
    split s, which walks the iterations `split_ranges[s]`: with g = 27 // tps
    tap groups per chunk of `chunk` input channels (bf16 64, fp32 16),
    iteration it is channels [chunk * c, chunk * (c + 1)), c = it // g, of the
    taps tps * (it % g) ... tps * (it % g) + tps - 1.  `split_shape` is the
    fp32 partial-sum buffer of a split-K call, `stats_shape` the per-block
    [sum, sumsq] buffer of a call with stats, `launches` the kernels the call
    launches, by counter."""

    tile: Tuple[int, int, int]
    bn: int
    tps: int
    stages: int
    splits: int
    split_ranges: Tuple[Tuple[int, int], ...]
    grid: Tuple[int, int, int]
    threads: int
    smem_bytes: int
    split_shape: Optional[Tuple[int, int, int]]
    stats_shape: Optional[Tuple[int, int, int]]
    launches: Dict[str, int]
    chunk: int = CHUNK

    @property
    def n_launches(self) -> int:
        return sum(self.launches.values())


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_conv3d(b: int, d: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
                flags: int = 0) -> ConvPlan:
    """The launch plan of one conv of a (b, d, h, w, cin) input to cout
    channels; `flags` are the kernel's (1 prologue, 2 bias, 4 residual,
    8 stats, 16 SiLU).  A pure function of its arguments.

    bf16: 128 output channels per block (1 tap per pipeline stage, 3
    stages) where Cout is a multiple of 128 and those blocks fill the 132
    SMs, else 64 (3 taps per stage, 2 stages).  A block is one warpgroup
    per output plane of an 8 x 8 tile, 2 planes (two blocks per SM), or 4
    (one block of 512 threads per SM, 9 taps per stage) where 64-wide
    4-plane blocks make DEEP_WAVES waves: the weight slab each block
    streams then serves twice the voxels.  Where the blocks are fewer than
    the SMs, K is split into up to 132 / blocks ranges of at least
    MIN_SPLIT_ITERS iterations, so that the small deep levels fill the
    card.  (Measured on an H100 at the fused path's convs: 4 planes ran
    level 0 9-11% faster, and 6-7% more with 9 taps per stage, the other
    levels slower; one wave of split blocks beat two; 64-wide split blocks
    beat 128-wide ones, having fewer fp32 partials to sum.)

    fp32: one block shape, F32_TILE (4 x 8 x 8 voxels) x 64 channels, 256
    threads of 8 x 8 register tiles, two blocks per SM; K in chunks of
    F32_CHUNK channels, 3 taps (one (dz, dy)) per stage of a two-stage ring;
    K split by the bf16 rule."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"plan_conv3d: bf16 or fp32, got {dtype}")
    stats = bool(flags & _STATS)
    m = b * d * h * w
    ty, tx = TILE_YX
    tiles = lambda tz: b * _cdiv(d, tz) * _cdiv(h, ty) * _cdiv(w, tx)
    if dtype == torch.float32:
        tz, bn, tps, stages, chunk, threads, smem = F32_TILE[0], 64, 3, 2, F32_CHUNK, 256, _F32_SMEM
    else:
        bn = 128 if cout % 128 == 0 and tiles(2) * cout // 128 >= SMS else 64
        tz = 4 if bn == 64 and tiles(4) * _cdiv(cout, bn) >= DEEP_WAVES * SMS else 2
        # taps per stage, stages: two 2-plane blocks fit on an SM either way; a 4-plane block has the SM alone
        tps, stages = (1, 3) if bn == 128 else ((3, 2) if tz == 2 else (9, 2))
        chunk, threads = CHUNK, 128 * tz
        smem = 1024 + stages * tps * bn * 128 + (tz + 2) * (ty + 2) * (tx + 2) * 128
    nt, mt = _cdiv(cout, bn), tiles(tz)
    n_it = 27 // tps * _cdiv(cin, chunk)
    splits = 1 if mt * nt >= SMS else max(1, min(_cdiv(SMS, mt * nt), n_it // MIN_SPLIT_ITERS))
    return ConvPlan(tile=(tz, ty, tx), bn=bn, tps=tps, stages=stages, splits=splits,
                    split_ranges=tuple((s * n_it // splits, (s + 1) * n_it // splits) for s in range(splits)),
                    grid=(mt, nt, splits), threads=threads, smem_bytes=smem,
                    split_shape=(splits, m, cout) if splits > 1 else None,
                    stats_shape=((mt if splits == 1 else _cdiv(m, 64)), 2, cout) if stats else None,
                    launches={"conv3d": 1, "conv3d_splitk_reduce": int(splits > 1),
                              "conv3d_stats_reduce": int(stats)}, chunk=chunk)


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


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"jig_conv3d": [_P] * 9 + [_I] * 14 + [_P],
             "jig_conv3d_splitk_reduce": [_P] * 5 + [_I] * 5 + [_P],
             "jig_conv3d_stats_reduce": [_P] * 2 + [_I] * 2 + [_P]}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """A C entry point of csrc/conv3d.cu, built on first use."""
    fn = getattr(load_library(CONV3D_SOURCE), name)
    fn.argtypes = _ARGTYPES[name]
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


def _raise_on(err: int, name: str, shape, cout: int, dtype) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} at x={tuple(shape)} -> {cout} {dtype}")


def _launch_plan(plan: ConvPlan, fn, ptrs: Dict[str, Optional[int]], shape, cout: int, dtype: torch.dtype,
                 flags: int, stream: int) -> None:
    """Issues the plan's kernels in order through `fn` (name -> C entry
    point; `_kernel_fn` on the card): the conv, then the split-K epilogue
    where `plan.splits` > 1, then the stats reduce with stats.  `ptrs` holds
    the device addresses of the tensors and of the buffers the plan sized.
    Raises on the first launch that fails; counts each launch."""
    b, d, h, w, cin = shape
    err = fn("jig_conv3d")(ptrs["x"], ptrs["wt"], ptrs["scale"], ptrs["shift"], ptrs["bias"], ptrs["residual"],
                           ptrs["out"], ptrs["partial"], ptrs["split"], b, d, h, w, cin, cout, _DTYPE_CODES[dtype],
                           flags, plan.tile[0], plan.bn, plan.tps, plan.stages, plan.splits, plan.smem_bytes,
                           stream)
    _raise_on(err, "conv3d", shape, cout, dtype)
    conv3d_igemm.launches += 1
    if plan.splits > 1:
        err = fn("jig_conv3d_splitk_reduce")(ptrs["split"], ptrs["bias"], ptrs["residual"], ptrs["out"],
                                             ptrs["partial"], b * d * h * w, cout, plan.splits, flags,
                                             _DTYPE_CODES[dtype], stream)
        _raise_on(err, "conv3d split-K reduce", shape, cout, dtype)
        conv3d_igemm.splitk_launches += 1
    if flags & _STATS:
        _stats_reduce(fn, ptrs["partial"], ptrs["stats"], plan.stats_shape[0], 2 * cout, stream)


def conv3d_igemm(x: torch.Tensor, kernel: torch.Tensor, scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None, want_stats: bool = False,
                 activate: bool = False) -> Out:
    """The conv on the card (CUDA tensors only): allocates what
    `plan_conv3d` says and launches `csrc/conv3d.cu`'s kernel (counted in
    `conv3d_igemm.launches`), its split-K epilogue where the plan splits K
    (`conv3d_igemm.splitk_launches`) and, with `want_stats`, the reduce of
    the per-block partial sums (`channel_stats_reduce.launches`).

    The bf16 kernel takes the weight as its (Cout, 27*Cin) transpose in x's
    dtype, made here per call (`kernel.permute(4, 0, 1, 2, 3)`): one pass
    over the weight, as the unfused path's per-op cast of its fp32
    parameters is.  The fp32 kernel takes the DHWIO kernel as it is,
    reshaped to (27*Cin, Cout)."""
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
    if x.dtype == torch.float32:
        wt = kernel.float().reshape(27 * cin, cout).contiguous()
    else:
        wt = kernel.permute(4, 0, 1, 2, 3).reshape(cout, 27 * cin).to(x.dtype).contiguous()
    f32 = lambda t: None if t is None else t.float().contiguous()
    scale, shift, bias = f32(scale), f32(shift), f32(bias)
    if residual is not None:
        if residual.dtype != x.dtype:
            raise TypeError(f"{who}: the kernel takes the residual in x's dtype {x.dtype}, got {residual.dtype}")
        residual = residual.contiguous()
    flags = ((_AFFINE if scale is not None else 0) | (_BIAS if bias is not None else 0)
             | (_RESIDUAL if residual is not None else 0) | (_STATS if want_stats else 0)
             | (_ACTIVATE if activate else 0))
    plan = plan_conv3d(b, d, h, w, cin, cout, x.dtype, flags)
    empty = lambda shape: None if shape is None else torch.empty(shape, dtype=torch.float32, device=x.device)
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    partial, split = empty(plan.stats_shape), empty(plan.split_shape)
    stats = empty((2, cout) if want_stats else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    ptrs = {"x": x.data_ptr(), "wt": wt.data_ptr(), "scale": ptr(scale), "shift": ptr(shift), "bias": ptr(bias),
            "residual": ptr(residual), "out": out.data_ptr(), "partial": ptr(partial), "split": ptr(split),
            "stats": ptr(stats)}
    with torch.cuda.device(x.device):
        _launch_plan(plan, _kernel_fn, ptrs, x.shape, cout, x.dtype, flags,
                     torch.cuda.current_stream(x.device).cuda_stream)
    return (out, stats) if want_stats else out


conv3d_igemm.launches = 0
conv3d_igemm.splitk_launches = 0


def _stats_reduce(fn, partial: int, stats: int, rows: int, cols: int, stream: int) -> None:
    err = fn("jig_conv3d_stats_reduce")(partial, stats, rows, cols, stream)
    if err != 0:
        raise RuntimeError(f"conv3d stats reduce launch failed: cudaError {err} at ({rows}, {cols})")
    channel_stats_reduce.launches += 1


def channel_stats_reduce(partial: torch.Tensor) -> torch.Tensor:
    """(rows, 2, C) fp32 partial sums -> (2, C), summed over rows in a fixed
    order by `csrc/conv3d.cu`'s reduce kernel (CUDA tensors only; counted in
    `channel_stats_reduce.launches`)."""
    if partial.device.type != "cuda" or partial.dtype != torch.float32 or partial.ndim != 3 \
            or partial.shape[1] != 2 or not partial.is_contiguous():
        raise ValueError(f"channel_stats_reduce wants a contiguous (rows, 2, C) fp32 CUDA tensor, got "
                         f"{tuple(partial.shape)} {partial.dtype} on {partial.device}")
    stats = torch.empty((2, partial.shape[2]), dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        _stats_reduce(_kernel_fn, partial.data_ptr(), stats.data_ptr(), partial.shape[0], 2 * partial.shape[2],
                      torch.cuda.current_stream(partial.device).cuda_stream)
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
