"""PyTorch port: the flash forward's launch planner (`ops/flash_attention.py`
`plan_flash_fwd`) and its padding path, checked on the CPU at the main paths'
bf16 shapes (`chip_smoke.py`'s flash phase), the edge shapes (ragged T, Tq !=
Tk, Tk <= 64, every padded head width) and fp32.

For each plan: the head width is the smallest of 16/32/64/128/256 that holds
D, the grid covers every q tile and output chunk once, shared memory fits a
block's 227 KB, csrc/flash_fwd.cu builds the (head width, warpgroups)
instance the plan names and checks the same shared-memory size, and two
warpgroups are taken where one-warpgroup blocks would be at most two per SM.
Then the kernel's blockwise online softmax, emulated here in float64 tile by
tile as the kernel runs it (running max from -1e30, keys past Tk at -inf,
two warpgroups splitting the key tiles and merged), equals the plain softmax:
the algebra holds where a warpgroup sees no key or only a ragged tile."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jointimagegeneration_torch.ops import flash_attention as tflash

MAIN = [(8, 2048, 2048, 32), (16, 1024, 1024, 32), (16, 4096, 4096, 32), (20, 1024, 1024, 32),
        (32, 4096, 4096, 32), (40, 1024, 1024, 32)]  # the last two: the 512x512 stage-2 validation batch
EDGE = [(3, 100, 77, 40), (2, 130, 200, 256), (2, 1088, 1088, 16), (1, 64, 64, 128), (2, 130, 70, 256),
        (1, 7, 3, 5), (2, 130, 40, 40)]
CASES = ([pytest.param(s, torch.bfloat16, id="bf16-" + "x".join(map(str, s))) for s in MAIN + EDGE]
         + [pytest.param(s, torch.float32, id="fp32-" + "x".join(map(str, s))) for s in MAIN[:1] + EDGE])
SM_SMEM = 233_472  # bytes of shared memory on one H100 SM (228 KB), 1 KB of it reserved per block
SOURCE = Path(tflash.__file__).resolve().parents[1] / "csrc" / "flash_fwd.cu"


def _built_instances():
    """(head width, warpgroups) of every bf16 instance launch_wgmma dispatches to."""
    found = re.findall(r"case (\d+): return launch_wgmma_as<(\d+), (\d+)>", SOURCE.read_text())
    assert found, "no bf16 instances found in csrc/flash_fwd.cu"
    for key, hd, wg in found:
        assert int(key) == int(hd) * 10 + int(wg), f"dispatch key {key} names another instance"
    return {(int(hd), int(wg)) for _, hd, wg in found}


@pytest.mark.parametrize("shape,dtype", CASES)
def test_plan_covers_and_fits(shape, dtype):
    bh, tq, tk, d = shape
    plan = tflash.plan_flash_fwd(bh, tq, tk, d, dtype)
    assert plan == tflash.plan_flash_fwd(bh, tq, tk, d, dtype)  # a pure function
    hd = plan.head_width
    assert hd in (16, 32, 64, 128, 256) and d <= hd and (hd == 16 or d > hd // 2)
    assert plan.chunk == min(hd, 64) and hd % plan.chunk == 0
    nch = hd // plan.chunk
    # one block per (bh, 64-row q tile, chunk, split)
    assert plan.grid == -(-tq // tflash.TILE) * bh * nch * plan.splits
    assert 0 < plan.smem_bytes <= tflash.SMEM_LIMIT
    if dtype == torch.bfloat16:
        assert plan.threads == 128 * plan.warpgroups and plan.warpgroups in (1, 2)
        assert (plan.splits, plan.merge_launches) == (1, 0)
    else:
        assert (plan.warpgroups, plan.threads, plan.swizzle) == (0, tflash.F32_THREADS, 0)
        rt = plan.rows
        assert rt == (64 if hd <= 64 else 32 if hd == 128 else 16) == tflash.f32_fwd_rows(hd)
        # the Q tile, two stages of K and V tiles of rt keys (rows padded by 4 floats), and P (rt, 64 + 4)
        assert plan.smem_bytes == 4 * (64 * (hd + 4) + 2 * 2 * rt * (hd + 4) + rt * 68)
        if hd <= 64:  # two blocks on an SM
            assert 2 * (plan.smem_bytes + 1024) <= SM_SMEM
        # splits: at most one per key tile and 16, and the grid within two blocks per SM where it splits
        blocks = plan.grid // plan.splits
        assert 1 <= plan.splits <= min(-(-tk // rt), tflash.F32_MAX_SPLITS)
        assert plan.splits == max(1, min(-(-tk // rt), 16, 2 * tflash.SMS // blocks))
        assert plan.splits == 1 or plan.grid <= 2 * tflash.SMS
        assert plan.merge_launches == int(plan.splits > 1)


@pytest.mark.parametrize("shape", [pytest.param(s, id="x".join(map(str, s))) for s in MAIN + EDGE])
def test_bf16_plan_matches_the_kernel(shape):
    """The swizzle follows the head width; the instance exists in the source;
    its shared memory is the kernel's layout (`FwdSmem`) with every tile on a
    1024-byte boundary; a two-warpgroup block's merge scratch fits a ring;
    one-warpgroup blocks fit four to an SM up to D = 32, two up to 128."""
    bh, tq, tk, d = shape
    plan = tflash.plan_flash_fwd(bh, tq, tk, d, torch.bfloat16)
    hd, tile, atom = plan.head_width, tflash.TILE * plan.head_width * 2, tflash.TILE * plan.chunk * 2
    assert plan.swizzle == 2 * plan.chunk and plan.swizzle in (32, 64, 128)
    assert (hd, plan.warpgroups) in _built_instances()
    assert tile % 1024 == 0 and (tile + atom) % 1024 == 0
    ring = tflash.STAGES * (tile + atom)
    assert plan.smem_bytes == 1024 + 1024 + tile + plan.warpgroups * ring  # slack, barriers, Q, rings
    if plan.warpgroups == 2:  # warpgroup 1's O, m and l pass through its ring
        assert (plan.chunk // 2 + 4) * 128 * 4 <= ring
    elif hd < 256:
        assert (4 if hd <= 32 else 2) * (plan.smem_bytes + 1024) <= SM_SMEM


@pytest.mark.parametrize("shape", [pytest.param(s, id="x".join(map(str, s))) for s in MAIN + EDGE])
def test_plan_warpgroups(shape):
    """Two warpgroups (splitting the key tiles) where one-warpgroup blocks
    would be at most two per SM and D < 256, else one.  At (2, 130, 40, 40)
    the block has one key tile, so warpgroup 1 sees no key."""
    plan = tflash.plan_flash_fwd(*shape, torch.bfloat16)
    assert plan.warpgroups == (2 if plan.grid <= 2 * tflash.SMS and plan.head_width < 256 else 1)
    if shape == (2, 130, 40, 40):
        assert plan.warpgroups == 2 and -(-shape[2] // tflash.TILE) == 1
    if shape in MAIN:
        assert plan.grid >= tflash.SMS


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        tflash.plan_flash_fwd(1, 64, 64, 32, torch.float16)
    for bad in ((0, 64, 64, 32), (1, 0, 64, 32), (1, 64, 0, 32), (1, 64, 64, 0), (1, 64, 64, 257)):
        with pytest.raises(ValueError):
            tflash.plan_flash_fwd(*bad, torch.bfloat16)


@pytest.mark.parametrize("d,offset", [(5, 0), (13, 0), (40, 0), (32, 1)])
def test_padding_path_slices_back_to_plain(d, offset):
    """bf16 with D % 8 != 0, or a view not 16-byte aligned: the forward runs
    on copies with zero columns up to D % 8 == 0, 16-byte aligned, and O
    sliced back equals the plain result on the unpadded inputs (a zero column
    adds nothing to q.k^T; the extra O columns are dropped).  The plain
    version stands in for the kernel on the CPU."""
    rs = np.random.RandomState(d)
    bh, tq, tk = 2, 70, 45
    base = [torch.from_numpy(rs.randn(bh * t * d + offset).astype(np.float32)).to(torch.bfloat16)
            for t in (tq, tk, tk)]
    q, k, v = (b[offset:].view(bh, t, d) for b, t in zip(base, (tq, tk, tk)))
    q = (q.float() / math.sqrt(d)).to(torch.bfloat16) if offset == 0 else q
    seen = []

    def forward(*tensors):
        seen.append([(tuple(t.shape), t.data_ptr() % 16, t.is_contiguous()) for t in tensors])
        return tflash.flash_attention_plain(*tensors)

    o, lse = tflash._tma_padded(forward, q, k, v)
    dp = d + (-d % 8)
    assert seen == [[((bh, tq, dp), 0, True), ((bh, tk, dp), 0, True), ((bh, tk, dp), 0, True)]]
    want_o, want_lse = tflash.flash_attention_plain(q, k, v)
    assert o.shape == q.shape and o.dtype == torch.bfloat16 and o.is_contiguous()
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=0)
    torch.testing.assert_close(o.float(), want_o.float(), atol=2 ** -8 * want_o.float().abs().max().item(), rtol=0)


def test_padding_path_passes_aligned_bf16_and_fp32_through():
    q = torch.zeros(1, 8, 16, dtype=torch.bfloat16)
    calls = []
    tflash._tma_padded(lambda *t: calls.append(t) or (t[0], None), q, q, q)
    assert calls[0][0] is q
    f = torch.zeros(1, 8, 12)  # fp32 takes D % 4 == 0
    tflash._tma_padded(lambda *t: calls.append(t) or (t[0], None), f, f, f)
    assert calls[1][0] is f


def _emulate(q, k, v, nwg):
    """The bf16 kernel's arithmetic in float64 without its roundings: per
    warpgroup the key tiles wg, wg + nwg, ... of 64, each one online-softmax
    step (keys past Tk at -inf before the max, m from -1e30, O and l rescaled
    once per tile), then the fixed-order merge of the warpgroups' states."""
    bh, tq, _ = q.shape
    tk, n_tiles = k.shape[1], -(-k.shape[1] // 64)
    states = []
    for wg in range(nwg):
        m = np.full((bh, tq, 1), -1e30)
        l = np.zeros((bh, tq, 1))
        o = np.zeros(q.shape)
        for j in range(wg, n_tiles, nwg):
            kt = np.zeros((bh, 64, q.shape[2]))
            vt = np.zeros((bh, 64, q.shape[2]))
            kt[:, :min(64, tk - 64 * j)] = k[:, 64 * j:64 * j + 64]
            vt[:, :min(64, tk - 64 * j)] = v[:, 64 * j:64 * j + 64]
            s = q @ kt.transpose(0, 2, 1)
            s[:, :, tk - 64 * j:] = -np.inf
            m_new = np.maximum(m, s.max(-1, keepdims=True))
            scale = np.exp2((m - m_new) * math.log2(math.e))
            p = np.exp2(s * math.log2(math.e) - m_new * math.log2(math.e))
            o, l, m = o * scale + p @ vt, l * scale + p.sum(-1, keepdims=True), m_new
        states.append((m, l, o))
    m, l, o = states[0]
    for m1, l1, o1 in states[1:]:
        mm = np.maximum(m, m1)
        a0, a1 = np.exp2((m - mm) * math.log2(math.e)), np.exp2((m1 - mm) * math.log2(math.e))
        m, l, o = mm, l * a0 + l1 * a1, o * a0 + o1 * a1
    return o / l, m + np.log(l)


@pytest.mark.parametrize("nwg", [1, 2])
@pytest.mark.parametrize("tq,tk", [(130, 40), (100, 77), (64, 200), (70, 128)])
def test_blockwise_softmax_and_merge_match_plain(tq, tk, nwg):
    rs = np.random.RandomState(tq + tk)
    q = rs.randn(2, tq, 24) / math.sqrt(24) * 3.0
    k, v = rs.randn(2, tk, 24), rs.randn(2, tk, 24)
    o, lse = _emulate(q, k, v, nwg)
    want_o, want_lse = tflash.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(o, want_o.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(lse, want_lse.numpy(), atol=1e-12, rtol=0)
