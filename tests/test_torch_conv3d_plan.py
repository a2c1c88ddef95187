"""PyTorch port: the conv kernel's launch planner (`ops/conv3d.py`
`plan_conv3d`), checked on the CPU at the 19 distinct convs of the fused
stage-1 path (`configs/sample_two_stage.yml`: base 64, mult (1, 2, 2, 4, 5),
64x128x128) in bf16 and in fp32 (the fused path in fp32), `chip_smoke.py`'s
edge shapes and the fp32 torso.

For each plan: the output tiles cover every voxel and channel exactly once
(by the block -> tile mapping `ConvPlan` documents and csrc/conv3d.cu
implements), the K splits partition [0, 27 * Cin) in order, shared memory
fits one block's 227 KB, every level-3/4 plan fills a wave of 132 SMs, and
the wrapper's launch sequence (`_launch_plan`, driven here through a
recording stand-in for the C entry points) issues exactly the plan's
launches with the plan's arguments."""

import numpy as np
import pytest
import torch

from jointimagegeneration_torch.ops import conv3d as tconv

LEVELS = {0: (64, 128, 128), 1: (32, 64, 64), 2: (16, 32, 32), 3: (8, 16, 16), 4: (4, 8, 8)}
FUSED_CONVS = [  # (level, Cin, Cout): the distinct convs of the fused stage-1 path
    (0, 64, 64), (0, 128, 64), (0, 192, 64),
    (1, 64, 128), (1, 128, 128), (1, 192, 128), (1, 256, 128),
    (2, 128, 128), (2, 256, 128), (2, 384, 128),
    (3, 128, 256), (3, 256, 256), (3, 384, 256), (3, 512, 256), (3, 576, 256),
    (4, 256, 320), (4, 320, 320), (4, 576, 320), (4, 640, 320),
]
EDGE = [((1, 3, 8, 10, 8), 12, 1 | 2 | 8), ((2, 3, 8, 8, 16), 16, 16), ((1, 2, 8, 8, 4), 8, 1 | 2 | 4),
        ((1, 5, 16, 24, 40), 72, 2 | 4 | 8), ((2, 9, 36, 40, 24), 72, 1 | 2 | 8)]
CASES = ([pytest.param((1, *LEVELS[lv], cin), cout, 1 | 2 | 8, torch.bfloat16, id=f"L{lv}-{cin}to{cout}")
          for lv, cin, cout in FUSED_CONVS]
         + [pytest.param(s, c, f, torch.bfloat16, id=f"edge-{'x'.join(map(str, s))}to{c}") for s, c, f in EDGE]
         + [pytest.param((1, 32, 64, 64, 128), 128, 1 | 2 | 8, torch.float32, id="fp32-torso")]
         + [pytest.param((1, *LEVELS[lv], cin), cout, 1 | 2 | 8, torch.float32, id=f"fp32-L{lv}-{cin}to{cout}")
            for lv, cin, cout in FUSED_CONVS]
         + [pytest.param(s, c, f, torch.float32, id=f"fp32-edge-{'x'.join(map(str, s))}to{c}")
            for s, c, f in EDGE])


def _tile_voxels(plan, shape):
    """Flat voxel index of every (block row i, tile position) the plan's grid
    writes, -1 where the tile hangs over the volume's edge."""
    b, d, h, w, _ = shape
    tz, ty, tx = plan.tile
    i = np.arange(plan.grid[0])[:, None]
    nx, ny, nz = -(-w // tx), -(-h // ty), -(-d // tz)
    x0, y0 = (i % nx) * tx, (i // nx % ny) * ty
    z0, bb = (i // (nx * ny) % nz) * tz, i // (nx * ny * nz)
    r = np.arange(tz * ty * tx)[None, :]
    z, y, x = z0 + r // (tx * ty), y0 + r // tx % ty, x0 + r % tx
    return np.where((z < d) & (y < h) & (x < w), ((bb * d + z) * h + y) * w + x, -1)


@pytest.mark.parametrize("shape,cout,flags,dtype", CASES)
def test_plan_covers_partitions_and_fits(shape, cout, flags, dtype):
    b, d, h, w, cin = shape
    plan = tconv.plan_conv3d(b, d, h, w, cin, cout, dtype, flags)
    assert plan == tconv.plan_conv3d(b, d, h, w, cin, cout, dtype, flags)  # a pure function

    # every output voxel and channel exactly once
    vox = _tile_voxels(plan, shape)
    # bf16: one warpgroup per 64-voxel plane; fp32: 256 threads of 8 voxels x 8 of the 64 channels
    assert vox.shape[1] == 64 * plan.tile[0] == (plan.threads // 2 if dtype == torch.bfloat16 else plan.threads)
    if dtype == torch.float32:
        assert (plan.tile, plan.bn, plan.tps, plan.stages, plan.chunk) == (tconv.F32_TILE, 64, 3, 2, 16)
        assert 2 * (plan.smem_bytes + 1024) <= 233_472  # two blocks on an SM
    counts = np.bincount(vox[vox >= 0], minlength=b * d * h * w)
    assert counts.size == b * d * h * w and (counts == 1).all()
    chans = np.concatenate([np.arange(j * plan.bn, min((j + 1) * plan.bn, cout)) for j in range(plan.grid[1])])
    assert np.array_equal(np.sort(chans), np.arange(cout))

    # the K splits: contiguous iteration ranges, in order, covering [0, 27 * Cin) once
    assert plan.chunk == (tconv.CHUNK if dtype == torch.bfloat16 else tconv.F32_CHUNK)
    groups, chunks = 27 // plan.tps, -(-cin // plan.chunk)
    assert plan.splits == plan.grid[2] == len(plan.split_ranges)
    assert plan.split_ranges[0][0] == 0 and plan.split_ranges[-1][1] == groups * chunks
    for (lo, hi), (nxt, _) in zip(plan.split_ranges, plan.split_ranges[1:]):
        assert lo < hi == nxt
    assert plan.split_ranges[-1][0] < plan.split_ranges[-1][1]
    k_seen = np.zeros(27 * cin, dtype=int)
    for lo, hi in plan.split_ranges:
        for it in range(lo, hi):
            c0 = it // groups * plan.chunk
            for tap in range(plan.tps * (it % groups), plan.tps * (it % groups + 1)):
                k_seen[tap * cin + c0: tap * cin + min(c0 + plan.chunk, cin)] += 1
    assert (k_seen == 1).all()

    # resources, and enough blocks where the grid would be thin
    assert plan.smem_bytes <= tconv.SMEM_LIMIT
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    if (d, h, w) in (LEVELS[3], LEVELS[4]):
        assert blocks >= tconv.SMS
    if plan.splits > 1:
        assert plan.grid[0] * plan.grid[1] < tconv.SMS
        assert plan.split_shape == (plan.splits, b * d * h * w, cout)
    else:
        assert plan.split_shape is None
    if flags & 8:
        rows = plan.grid[0] if plan.splits == 1 else -(-b * d * h * w // 64)
        assert plan.stats_shape == (rows, 2, cout)
    else:
        assert plan.stats_shape is None


@pytest.mark.parametrize("shape,cout,flags,dtype", CASES)
def test_wrapper_issues_the_planned_launches(shape, cout, flags, dtype):
    b, d, h, w, cin = shape
    plan = tconv.plan_conv3d(b, d, h, w, cin, cout, dtype, flags)
    calls = []

    def fn(name):
        def c_entry(*args):
            calls.append((name, args))
            return 0
        return c_entry

    ptrs = {k: i + 1 for i, k in enumerate(("x", "wt", "scale", "shift", "bias", "residual", "out", "partial",
                                            "split", "stats"))}
    before = (tconv.conv3d_igemm.launches, tconv.conv3d_igemm.splitk_launches, tconv.channel_stats_reduce.launches)
    tconv._launch_plan(plan, fn, ptrs, shape, cout, dtype, flags, 0)
    names = [n for n, _ in calls]
    assert len(names) == plan.n_launches
    assert names == ["jig_conv3d"] + ["jig_conv3d_splitk_reduce"] * (plan.splits > 1) \
        + ["jig_conv3d_stats_reduce"] * bool(flags & 8)
    after = (tconv.conv3d_igemm.launches, tconv.conv3d_igemm.splitk_launches, tconv.channel_stats_reduce.launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [plan.launches[k] for k in
                                                       ("conv3d", "conv3d_splitk_reduce", "conv3d_stats_reduce")]
    conv_args = calls[0][1]
    assert conv_args[9:15] == (b, d, h, w, cin, cout)
    assert conv_args[15:23] == (0 if dtype == torch.bfloat16 else 1, flags, plan.tile[0], plan.bn, plan.tps,
                                plan.stages, plan.splits, plan.smem_bytes)
    assert len(conv_args) == len(tconv._ARGTYPES["jig_conv3d"])
    if flags & 8:
        assert calls[-1][1][2:4] == (plan.stats_shape[0], 2 * cout)


def test_launch_failure_raises():
    plan = tconv.plan_conv3d(1, 4, 8, 8, 64, 64, torch.bfloat16, 0)
    ptrs = dict.fromkeys(("x", "wt", "scale", "shift", "bias", "residual", "out", "partial", "split", "stats"), 1)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tconv._launch_plan(plan, lambda name: (lambda *a: 1), ptrs, (1, 4, 8, 8, 64), 64, torch.bfloat16, 0, 0)


def test_fused_path_conv_calls_match_the_unet():
    """chip_smoke.py takes the fused path's launch counts from the planner over
    `fused_conv_calls`, whose ResBlock channels must be the UNet's own."""
    import chip_smoke
    from jointimagegeneration_torch.nn.blocks import ResBlock
    from jointimagegeneration_torch.nn.unet import UNet

    cfg = {"base_channels": 8, "channel_mult": [1, 2, 2, 4, 5], "num_res_blocks": 2}
    unet = UNet(13, 8, 12, channel_mult=(1, 2, 2, 4, 5), attention_resolutions=(), device="cpu")
    built = [(m.in_ch, m.out_ch) for m in unet.children() if isinstance(m, ResBlock)]
    assert built == [(i, o) for _, i, o in chip_smoke.resblock_channels(cfg)]
    full = chip_smoke.fused_conv_calls(chip_smoke.TWO_STAGE_CFG["stage1"]["unet_openai"], (64, 128, 128), "kernel")
    assert len(full) == 54
    assert sorted({(s[1], s[-1], c) for s, c, _ in full}) == sorted(
        (LEVELS[lv][0], cin, cout) for lv, cin, cout in FUSED_CONVS)
    counts = chip_smoke.planned_launches(tconv, full)
    assert counts["conv3d"] == 54 and counts["conv3d_stats_reduce"] == 27
    assert counts["conv3d_splitk_reduce"] == 24  # every conv at levels 3-4 splits K
