"""PyTorch port: the flash backward's launch planner (`ops/flash_attention.py`
`plan_flash_bwd`), checked on the CPU at the training shapes (`chip_smoke.py`'s
BWD_SHAPES), its edge shapes (ragged T, Tq != Tk, every padded head width) and
fp32.

For each plan: the head width is the smallest of 16/32/64/128/256 that holds
D, the grid covers every row tile, output chunk and (fp32) split once, shared
memory fits a block's 227 KB (and two blocks on an SM below D = 256, where the
bf16 plan takes one warpgroup per block, and up to D = 64 in fp32), a
two-warpgroup block's reduction scratch fits in a ring, and csrc/flash_bwd.cu
builds the (head width, warpgroups) instance the plan names and checks the
same shared-memory size.

fp32: the splits of each kernel's streamed loop (dkv: q tiles, dq: key tiles)
fill about two blocks per SM with at least one streamed tile per split, the
reduce launch appears iff a loop is split, and a float64 emulation of the
kernels' decomposition (per block and split: the streamed tiles [s n /
splits, (s + 1) n / splits), rows past Tq at LSE = +inf in dkv, keys past Tk
at P = 0 in dq, zero-filled tiles; then the partials summed in split order)
equals `flash_backward_plain`, also where a split gets no tile."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jointimagegeneration_torch.ops import flash_attention as tflash

MAIN = [(8, 2048, 2048, 32), (16, 1024, 1024, 32), (16, 4096, 4096, 32), (20, 1024, 1024, 32)]
EDGE = [(3, 100, 77, 40), (2, 130, 200, 256), (2, 1088, 1088, 16), (1, 64, 64, 128), (2, 130, 70, 256),
        (1, 7, 3, 5), (2, 600, 600, 64)]
# fp32: the text refiner's rows (8 heads x 64 over a 512- and a 640-token
# report), the train / text reference phases' (2 heads of 16 or 64) and the
# ragged split shapes of chip_smoke.py
F32 = [(8, 512, 512, 64), (8, 640, 640, 64), (4, 512, 512, 16), (2, 512, 512, 64), (3, 1000, 77, 40),
       (2, 77, 1000, 64), (1, 65, 4097, 16)]
CASES = ([pytest.param(s, torch.bfloat16, id="bf16-" + "x".join(map(str, s))) for s in MAIN + EDGE]
         + [pytest.param(s, torch.float32, id="fp32-" + "x".join(map(str, s))) for s in MAIN[:1] + EDGE + F32])
SM_SMEM = 233_472  # bytes of shared memory on one H100 SM (228 KB), 1 KB of it reserved per block
SOURCE = Path(tflash.__file__).resolve().parents[1] / "csrc" / "flash_bwd.cu"


def _built_instances():
    """(head width, warpgroups) of every bf16 instance launch_wgmma dispatches to."""
    text = SOURCE.read_text()
    found = re.findall(r"case (\d+): return launch_wgmma_as<kDkv, (\d+), (\d+)>", text)
    assert found, "no bf16 instances found in csrc/flash_bwd.cu"
    for key, hd, wg in found:
        assert int(key) == int(hd) * 10 + int(wg), f"dispatch key {key} names another instance"
    return {(int(hd), int(wg)) for _, hd, wg in found}


@pytest.mark.parametrize("shape,dtype", CASES)
def test_plan_covers_and_fits(shape, dtype):
    bh, tq, tk, d = shape
    plan = tflash.plan_flash_bwd(bh, tq, tk, d, dtype)
    assert plan == tflash.plan_flash_bwd(bh, tq, tk, d, dtype)  # a pure function
    hd = plan.head_width
    assert hd in (16, 32, 64, 128, 256) and d <= hd and (hd == 16 or d > hd // 2)
    assert plan.chunk == min(hd, 64) and hd % plan.chunk == 0
    nch = hd // plan.chunk
    for kp, rows, streamed in ((plan.dkv, tk, tq), (plan.dq, tq, tk)):
        # one block per (bh, 64-row tile, chunk, split), every split with a streamed tile
        assert kp.grid == -(-rows // tflash.TILE) * bh * nch * kp.splits
        assert 1 <= kp.splits <= -(-streamed // kp.rows)
        assert kp.reduce_launches == int(kp.splits > 1)
        assert 0 < kp.smem_bytes <= tflash.SMEM_LIMIT
        if dtype == torch.bfloat16:
            assert kp.threads == 128 * kp.warpgroups and kp.warpgroups in (1, 2)
            assert (kp.splits, kp.rows) == (1, tflash.TILE)
        else:
            assert (kp.warpgroups, kp.threads, kp.rows) == (0, 256, tflash.f32_bwd_rows(hd))


@pytest.mark.parametrize("shape", [pytest.param(s, id="x".join(map(str, s))) for s in MAIN + EDGE])
def test_bf16_plan_matches_the_kernels(shape):
    """The swizzle follows the head width; the instance exists in the source;
    its shared memory is the kernel's layout (`Smem`) with every
    tile on a 1024-byte boundary; a two-warpgroup block's reduction scratch
    fits a ring."""
    bh, tq, tk, d = shape
    plan = tflash.plan_flash_bwd(bh, tq, tk, d, torch.bfloat16)
    hd, tile = plan.head_width, tflash.TILE * plan.head_width * 2
    assert plan.swizzle == 2 * plan.chunk and plan.swizzle in (32, 64, 128)
    assert tile % 1024 == 0
    built = _built_instances()
    for name, kp in (("dkv", plan.dkv), ("dq", plan.dq)):
        assert (hd, kp.warpgroups) in built
        stage = 2 * tile + (1024 if name == "dkv" else 0)
        assert stage % 1024 == 0
        own = 1024 + 1024 + 2 * tile  # alignment slack, the barrier slot, the block's own two tiles
        assert kp.smem_bytes == own + kp.warpgroups * tflash.STAGES * stage
        if kp.warpgroups == 2:  # warpgroup 1's accumulator passes through its ring
            assert 64 * plan.chunk * 4 <= tflash.STAGES * stage
        if kp.warpgroups == 1 and hd < 256:  # two blocks share an SM
            assert 2 * (kp.smem_bytes + 1024) <= SM_SMEM


@pytest.mark.parametrize("shape", [pytest.param(s, id="x".join(map(str, s))) for s in MAIN])
def test_plan_warpgroups_at_the_training_shapes(shape):
    """dkv: one warpgroup per block; dq: two (splitting the key loop) where
    one-warpgroup blocks would be at most two per SM, else one.  Every
    training shape gives each kernel at least one block per SM."""
    plan = tflash.plan_flash_bwd(*shape, torch.bfloat16)
    assert plan.dkv.warpgroups == 1
    assert plan.dq.warpgroups == (2 if plan.dq.grid <= 2 * tflash.SMS else 1)
    assert min(plan.dkv.grid, plan.dq.grid) >= tflash.SMS


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        tflash.plan_flash_bwd(1, 64, 64, 32, torch.float16)
    for bad in ((0, 64, 64, 32), (1, 0, 64, 32), (1, 64, 64, 257)):
        with pytest.raises(ValueError):
            tflash.plan_flash_bwd(*bad, torch.bfloat16)


def _f32_smem(kernel, hd):
    """csrc/flash_bwd.cu's `F32Smem`, from its layout: own tiles (64 rows),
    two stages of the streamed pair, row data, transposed tiles; rows of hd
    + 4 floats, transposed rows of 64 + 4."""
    rt, ld = {16: 64, 32: 64, 64: 32, 128: 32, 256: 16}[hd], hd + 4
    floats = 2 * 64 * ld + 2 * (2 * rt * ld)
    floats += 2 * 2 * rt + 2 * rt * 68 if kernel == "dkv" else 2 * 64 + rt * 68
    return 4 * floats


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_fp32_plan_matches_the_kernels(hd):
    """The plan's shared memory is the kernel's layout at every head width,
    rows of 16-byte multiples (float4 and cp.async); two blocks share an SM
    up to D = 64, and the source names the same streamed rows."""
    plan = tflash.plan_flash_bwd(2, 256, 256, hd, torch.float32)
    assert plan.swizzle == 0 and plan.dkv.rows == plan.dq.rows == tflash.f32_bwd_rows(hd)
    assert plan.dkv.rows % 16 == 0 and ((hd + 4) * 4) % 16 == 0
    for name, kp in (("dkv", plan.dkv), ("dq", plan.dq)):
        assert kp.smem_bytes == _f32_smem(name, hd)
        if hd <= 64:
            assert 2 * (kp.smem_bytes + 1024) <= SM_SMEM
    text = SOURCE.read_text()
    assert "return HD <= 32 ? 64 : (HD <= 128 ? 32 : 16);" in text
    # the block size is shared with the fp32 forward, in flash_common.cuh
    assert "kF32Threads = 256" in (SOURCE.parent / "flash_common.cuh").read_text()


@pytest.mark.parametrize("shape", [pytest.param(s, id="x".join(map(str, s))) for s in MAIN[:1] + F32[:2]])
def test_fp32_splits_fill_the_card(shape):
    """The refiner's 512- and 640-token rows: 64 and 80 blocks of 64 keys or
    rows become at least 2 * SMS * 0.9 with their splits (the 64 blocks of
    the one-thread-per-row kernels become 256); at (8, 2048, 32) the blocks
    already fill two per SM, so no split and no reduce."""
    plan = tflash.plan_flash_bwd(*shape, torch.float32)
    for kp in (plan.dkv, plan.dq):
        base = kp.grid // kp.splits
        assert kp.splits == tflash.f32_bwd_splits(base, -(-shape[1] // kp.rows))
        if shape[1] == 2048:
            assert kp.splits == 1 and kp.grid == 256
        else:
            assert kp.splits > 1 and 0.9 * 2 * tflash.SMS <= kp.grid <= 2 * tflash.SMS
    assert tflash.f32_bwd_splits(1, 3) == 3 and tflash.f32_bwd_splits(1, 1000) == tflash.F32_MAX_SPLITS
    assert tflash.f32_bwd_splits(500, 10) == 1


def _emulate(q, k, v, o, lse, do, rt, splits_dkv, splits_dq):
    """The fp32 kernels' decomposition in float64: delta = rowsum(dO * O);
    dkv per 64-key tile and split s its q tiles [s n / S, (s + 1) n / S) of
    rt rows (zero-filled past Tq, LSE = +inf there so P = 0), dq per 64-row
    tile and split its key tiles (zero-filled past Tk, P = 0 there); the
    partials summed in split order."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    delta = (do * o).sum(-1)
    pad = lambda x, n: np.concatenate([x, np.zeros((bh, n - x.shape[1], d))], 1)
    n_q, n_k = -(-tq // rt), -(-tk // rt)
    qp, dop = pad(q, n_q * rt), pad(do, n_q * rt)
    lp = np.concatenate([lse[..., 0], np.full((bh, n_q * rt - tq), np.inf)], 1)
    dlp = np.concatenate([delta, np.zeros((bh, n_q * rt - tq))], 1)
    kp, vp = pad(k, n_k * rt), pad(v, n_k * rt)
    dk, dv, dq = np.zeros(k.shape), np.zeros(v.shape), np.zeros(q.shape)
    for n0 in range(0, tk, 64):
        kt, vt = k[:, n0:n0 + 64], v[:, n0:n0 + 64]
        parts = []
        for s in range(splits_dkv):
            pk, pv = np.zeros(kt.shape), np.zeros(vt.shape)
            for j in range(s * n_q // splits_dkv, (s + 1) * n_q // splits_dkv):
                rows = slice(j * rt, (j + 1) * rt)
                st = kt @ qp[:, rows].transpose(0, 2, 1)
                pt = np.exp2(st * math.log2(math.e) - lp[:, None, rows] * math.log2(math.e))
                dst = pt * (vt @ dop[:, rows].transpose(0, 2, 1) - dlp[:, None, rows])
                pv += pt @ dop[:, rows]
                pk += dst @ qp[:, rows]
            parts.append((pk, pv))
        dk[:, n0:n0 + 64] = sum(p[0] for p in parts)
        dv[:, n0:n0 + 64] = sum(p[1] for p in parts)
    for m0 in range(0, tq, 64):
        qt, dot = q[:, m0:m0 + 64], do[:, m0:m0 + 64]
        l2 = lse[:, m0:m0 + 64] * math.log2(math.e)
        dl = delta[:, m0:m0 + 64, None]
        parts = []
        for s in range(splits_dq):
            part = np.zeros(qt.shape)
            for j in range(s * n_k // splits_dq, (s + 1) * n_k // splits_dq):
                keys = slice(j * rt, (j + 1) * rt)
                p = np.exp2((qt @ kp[:, keys].transpose(0, 2, 1)) * math.log2(math.e) - l2)
                p[:, :, max(0, tk - j * rt):] = 0.0  # keys past tk
                part += (p * (dot @ vp[:, keys].transpose(0, 2, 1) - dl)) @ kp[:, keys]
            parts.append(part)
        dq[:, m0:m0 + 64] = sum(parts)
    return dq, dk, dv


@pytest.mark.parametrize("shape,splits", [
    pytest.param((2, 100, 77, 40), None, id="plan-2x100x77x40"),
    pytest.param((1, 130, 70, 24), None, id="plan-1x130x70x24"),
    pytest.param((2, 77, 300, 16), None, id="plan-2x77x300x16"),
    pytest.param((1, 65, 150, 8), (5, 7), id="more-splits-than-tiles-1x65x150x8"),
    pytest.param((2, 96, 64, 12), (2, 1), id="even-tiles-2x96x64x12"),
])
def test_fp32_split_decomposition_matches_plain(shape, splits):
    """The float64 emulation of the kernels' split partials and fixed-order
    sum against `flash_backward_plain` (float64), at the plan's splits and at
    splits past the streamed tiles (some splits get none and add zeros)."""
    bh, tq, tk, d = shape
    rs = np.random.RandomState(tq + tk + d)
    q = rs.randn(bh, tq, d) / math.sqrt(d) * 2.0
    k, v, do = rs.randn(bh, tk, d), rs.randn(bh, tk, d), rs.randn(bh, tq, d)
    o, lse = tflash.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    o, lse = o.numpy(), lse.numpy()
    plan = tflash.plan_flash_bwd(bh, tq, tk, d, torch.float32)
    if splits is None:
        splits = (plan.dkv.splits, plan.dq.splits)
        assert max(splits) > 1  # the emulation covers a split loop
    got = _emulate(q, k, v, o, lse, do, plan.dkv.rows, *splits)
    want = tflash.flash_backward_plain(*(torch.from_numpy(x) for x in (q, k, v, o, lse, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-12 * max(1.0, np.abs(w.numpy()).max()), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,d,offset,padded", [
    (torch.float32, 6, 0, (8, 70, 45)), (torch.float32, 8, 1, (8, 70, 45)), (torch.float32, 8, 0, None),
    (torch.bfloat16, 6, 0, (8, 72, 45))])
def test_padding_path_slices_back(dtype, d, offset, padded):
    """Where the kernels' loads do not take the tensors (fp32: D % 4 != 0 or
    a view not 16-byte aligned; bf16: D % 8, Tq % 4), `flash_backward` runs
    them on padded copies and slices the gradients back, equal to the plain
    gradients of the unpadded inputs; otherwise on the tensors themselves.
    The plain version stands in for the kernels on the CPU."""
    rs = np.random.RandomState(d + offset)
    bh, tq, tk = 2, 70, 45
    base = [torch.from_numpy(rs.randn(bh * t * d + offset).astype(np.float32)).to(dtype)
            for t in (tq, tk, tk, tq)]
    q, k, v, do = (b[offset:].view(bh, t, d) for b, t in zip(base, (tq, tk, tk, tq)))
    o, lse = tflash.flash_attention_plain(q, k, v)
    seen = []

    def backward(*tensors):
        seen.append((tuple(tensors[0].shape[2:]) + tuple(tensors[0].shape[1:2]) + tuple(tensors[1].shape[1:2]),
                     all(t.data_ptr() % 16 == 0 for t in tensors)))
        return tflash.flash_backward_plain(*tensors)

    got = tflash._bwd_padded(backward, q, k, v, o, lse, do)
    if padded is None:
        assert seen == [((d, tq, tk), offset == 0)]
    else:
        assert seen == [(padded, True)]
    want = tflash.flash_backward_plain(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype and g.is_contiguous()
        torch.testing.assert_close(g.float(), w.float(), atol=1e-6 * w.float().abs().max().item(), rtol=0)
