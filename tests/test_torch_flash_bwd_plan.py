"""PyTorch port: the flash backward's launch planner (`ops/flash_attention.py`
`plan_flash_bwd`), checked on the CPU at the training shapes (`chip_smoke.py`'s
BWD_SHAPES), its edge shapes (ragged T, Tq != Tk, every padded head width) and
fp32.

For each plan: the head width is the smallest of 16/32/64/128/256 that holds
D, the grid covers every row tile and output chunk once, shared memory fits a
block's 227 KB (and two blocks on an SM below D = 256, where the plan takes
one warpgroup per block), a two-warpgroup block's reduction scratch fits in a ring,
and csrc/flash_bwd.cu builds the (head width, warpgroups) instance the plan
names and checks the same shared-memory size."""

import re
from pathlib import Path

import pytest
import torch

from jointimagegeneration_torch.ops import flash_attention as tflash

MAIN = [(8, 2048, 2048, 32), (16, 1024, 1024, 32), (16, 4096, 4096, 32), (20, 1024, 1024, 32)]
EDGE = [(3, 100, 77, 40), (2, 130, 200, 256), (2, 1088, 1088, 16), (1, 64, 64, 128), (2, 130, 70, 256),
        (1, 7, 3, 5), (2, 600, 600, 64)]
CASES = ([pytest.param(s, torch.bfloat16, id="bf16-" + "x".join(map(str, s))) for s in MAIN + EDGE]
         + [pytest.param(s, torch.float32, id="fp32-" + "x".join(map(str, s))) for s in MAIN[:1] + EDGE])
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
    assert plan.chunk == (min(hd, 64) if dtype == torch.bfloat16 else hd) and hd % plan.chunk == 0
    nch = hd // plan.chunk if dtype == torch.bfloat16 else 1
    for kp, rows in ((plan.dkv, tk), (plan.dq, tq)):
        assert kp.grid == -(-rows // tflash.TILE) * bh * nch  # one block per (bh, 64-row tile, chunk)
        assert 0 < kp.smem_bytes <= tflash.SMEM_LIMIT
        if dtype == torch.bfloat16:
            assert kp.threads == 128 * kp.warpgroups and kp.warpgroups in (1, 2)
        else:
            assert (kp.warpgroups, kp.threads) == (0, tflash.TILE)


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
