"""PyTorch port: the GroupNorm kernel pair's host side (`ops/group_norm.py`)
and its wiring into the UNets' GroupNorm sites (`nn/blocks.group_norm`),
checked on the CPU.

  * the launch planner at every distinct GroupNorm shape of the benchmark's
    two cells (`ldm_unet2d.sample_256_b4`: 2D, b = 4, 256x256;
    `ccdm_unet3d.sample_b1`: 3D, b = 1, 64x128x128; both with their fp32
    `out_norm`) and at edge shapes: the tiles cover every row once, the row
    slots and lanes every row and vector of a tile once, shared memory fits,
    and each cell shape's launch fills one wave of 132 SMs;
  * the wrapper, driven through a recording stand-in for the C entry points,
    issues exactly the plan's two launches with the plan's arguments, and a
    UNet call of each cell's architecture issues two at each of its 66 sites;
  * CPU tensors and `Sharded` inputs compute what the composite computed
    before the kernel, bit for bit;
  * the kernel's fold of the tile partials (Chan's formula), the add, gamma,
    beta and FiLM into a per-(b, c) centre, scale and shift, written here in
    plain torch as csrc/group_norm.cu computes it, against a float64
    composite, on a near-constant field and with the add before the
    statistics;
  * the kernels' names, as csrc/group_norm.cu writes them, classify as
    `norm_reduce` and `elementwise` in the benchmark's and the port's tables.
"""

import math
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from jointimagegeneration_torch.core.logging import kind_of as port_kind_of
from jointimagegeneration_torch.nn import blocks
from jointimagegeneration_torch.ops import group_norm as gn
from jointimagegeneration_torch.parallel import spatial
from perfbench.kinds import kind_of as bench_kind_of

ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32
# (rows a sample, channels, dtype) of every distinct GroupNorm of one UNet call
SLICE_SHAPES = [(65536, 128, BF16), (65536, 128, F32), (65536, 256, BF16), (65536, 384, BF16),
                (16384, 128, BF16), (16384, 256, BF16), (16384, 384, BF16), (16384, 512, BF16), (16384, 768, BF16),
                (4096, 256, BF16), (4096, 512, BF16), (4096, 768, BF16), (4096, 1024, BF16),
                (1024, 512, BF16), (1024, 1024, BF16), (1024, 1152, BF16),
                (256, 512, BF16), (256, 640, BF16), (256, 1152, BF16), (256, 1280, BF16)]
MASK_SHAPES = [(1048576, 64, BF16), (1048576, 64, F32), (1048576, 128, BF16), (1048576, 192, BF16),
               (131072, 64, BF16), (131072, 128, BF16), (131072, 192, BF16), (131072, 256, BF16),
               (16384, 128, BF16), (16384, 256, BF16), (16384, 384, BF16),
               (2048, 128, BF16), (2048, 256, BF16), (2048, 384, BF16), (2048, 512, BF16), (2048, 576, BF16),
               (256, 256, BF16), (256, 320, BF16), (256, 576, BF16), (256, 640, BF16)]
CELL_CASES = ([pytest.param(4, s, c, dt, id=f"slices-{s}x{c}-{str(dt)[6:]}") for s, c, dt in SLICE_SHAPES]
              + [pytest.param(1, s, c, dt, id=f"mask-{s}x{c}-{str(dt)[6:]}") for s, c, dt in MASK_SHAPES])
EDGE_CASES = [pytest.param(b, s, c, g, dt, al, id=f"edge-{b}x{s}x{c}g{g}-{str(dt)[6:]}{'' if al else '-unaligned'}")
              for b, s, c, g, dt, al in [(3, 7, 12, 4, BF16, True), (2, 1, 96, 32, F32, True), (1, 5000, 3, 1, F32, True),
                                         (4, 99, 1000, 8, BF16, True), (2, 300, 2052, 4, F32, True),
                                         (1, 40, 64, 32, BF16, False), (16, 1, 640, 32, BF16, True)]]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_plan(plan, b, s, c, groups, dtype, aligned):
    assert plan == gn.plan_group_norm(b, s, c, groups, dtype, aligned)  # a pure function
    full = 8 if dtype == BF16 else 4
    assert plan.vec == (full if aligned and c % full == 0 else 1)
    nvec = c // plan.vec
    # the tiles cover [0, s) once each
    starts = [t * plan.rows for t in range(plan.tiles)]
    covered = torch.zeros(s, dtype=torch.int32)
    for r0 in starts:
        covered[r0:r0 + plan.rows] += 1
    assert covered.eq(1).all() and starts[-1] < s
    # within a tile, the row slots (ty, ty + rpp, ...) and the lanes' vectors (lane, lane + tpr, ...) once each
    for nrows in {min(plan.rows, s - r0) for r0 in starts}:
        rows = sorted(r for ty in range(plan.rpp) for r in range(ty, nrows, plan.rpp))
        assert rows == list(range(nrows))
    vecs = sorted(v for lane in range(plan.tpr) for v in range(lane, nvec, plan.tpr))
    assert vecs == list(range(nvec))
    assert plan.tpr * math.ceil(nvec / plan.tpr) - nvec < math.ceil(nvec / plan.tpr)  # passes equally filled
    assert plan.threads % 32 == 0 and plan.threads <= gn.MAX_THREADS
    assert plan.threads - 32 < plan.tpr * plan.rpp <= plan.threads
    assert plan.smem_bytes == 4 * (2 * c + 2 * plan.rpp * plan.tpr * plan.vec) <= gn.SMEM_LIMIT
    assert plan.partial_floats == b * plan.tiles * groups * 2
    assert plan.workspace == plan.partial_floats + 3 * b * c


@pytest.mark.parametrize("b,s,c,dtype", CELL_CASES)
def test_plan_covers_rows_and_fills_a_wave(b, s, c, dtype):
    plan = gn.plan_group_norm(b, s, c, 32, dtype)
    _check_plan(plan, b, s, c, 32, dtype, True)
    assert plan.vec == (8 if dtype == BF16 else 4)  # every cell shape takes 16-byte loads
    assert gn.SMS <= plan.tiles * b <= gn.SMS * gn.BLOCKS_PER_SM  # one wave that reaches every SM


@pytest.mark.parametrize("b,s,c,groups,dtype,aligned", EDGE_CASES)
def test_plan_edge_shapes(b, s, c, groups, dtype, aligned):
    plan = gn.plan_group_norm(b, s, c, groups, dtype, aligned)
    _check_plan(plan, b, s, c, groups, dtype, aligned)
    assert plan.tiles * b <= gn.SMS * gn.BLOCKS_PER_SM or plan.rows == 1


def test_plan_refuses():
    with pytest.raises(TypeError):
        gn.plan_group_norm(1, 8, 64, 32, torch.float16)
    with pytest.raises(ValueError):
        gn.plan_group_norm(1, 8, 60, 32, BF16)
    with pytest.raises(ValueError):  # shared memory past one block's 227 KB
        gn.plan_group_norm(1, 8, 40000, 8, F32)


class Recorder:
    """A stand-in for the C entry points: records each call and returns
    `err` (0: launched)."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __call__(self, name):
        return lambda *args: self.calls.append((name, args)) or self.err


@pytest.fixture
def recorder(monkeypatch):
    """`_kernel_fn` replaced by a Recorder, and the current-device binding by
    one that a CPU tensor matches, so the wrapper's whole CUDA path runs on
    CPU tensors (its outputs are left unwritten)."""
    rec = Recorder()
    monkeypatch.setattr(gn, "_kernel_fn", rec)
    monkeypatch.setattr(gn, "_cuda_bindings", lambda: (lambda: None, lambda index: 1234))
    return rec


@pytest.mark.parametrize("silu,opt", [(False, None), (True, "add"), (True, "film"), (True, "film2"), (True, "add1")])
@pytest.mark.parametrize("shape,groups,dtype", [((4, 16, 16, 128), 32, BF16), ((1, 4, 8, 8, 320), 32, BF16),
                                                ((2, 10, 12), 4, F32), ((2, 9, 30), 3, BF16)])
def test_launches_follow_the_plan(recorder, shape, groups, dtype, silu, opt):
    b, c = shape[0], shape[-1]
    s = math.prod(shape[1:-1])
    x = torch.randn(shape).to(dtype)
    gamma, beta = torch.randn(c), torch.randn(c)
    emb = torch.randn(b, 2 * c)
    add = emb[:, :c].contiguous() if opt == "add" else emb[:1, :c] if opt == "add1" else None
    film = (emb.chunk(2, dim=-1) if opt == "film" else (0.2 * emb[:, :c], emb[:, c:]) if opt == "film2"
            else (None, None))
    before = gn.group_norm_act.launches
    y = gn._forward_kernel(x, gamma, beta, groups, 1e-6, silu, add, *film)
    assert y.shape == x.shape and y.dtype == dtype
    assert gn.group_norm_act.launches - before == 2
    plan = gn.plan_group_norm(b, s, c, groups, dtype, x.data_ptr() % 16 == 0)
    (n1, a1), (n2, a2) = recorder.calls
    assert (n1, n2) == ("jig_gn_stats", "jig_gn_apply")
    add_stride = add.stride(0) if add is not None and add.shape[0] == b else 0
    stride = lambda t: 0 if t is None or t.shape[0] != b else t.stride(0)
    ptr = lambda t: None if t is None else t.data_ptr()
    assert a1[:6] == (x.data_ptr(), ptr(add), gamma.data_ptr(), beta.data_ptr(), ptr(film[0]), ptr(film[1]))
    assert a2[:3] == (x.data_ptr(), a1[6], y.data_ptr()) and a1[9] == a2[4] == 1234
    assert a2[3] is a1[8]  # one shape for both launches, made once
    sh = a1[8].contents
    assert (sh.b, sh.s, sh.c, sh.groups, sh.dtype) == (b, s, c, groups, 0 if dtype == BF16 else 1)
    assert (sh.vec, sh.tiles, sh.rows, sh.tpr, sh.rpp, sh.threads, sh.smem_bytes) == (
        plan.vec, plan.tiles, plan.rows, plan.tpr, plan.rpp, plan.threads, plan.smem_bytes)
    assert (sh.add_stride, sh.scale_stride, sh.shift_stride, sh.silu) == (add_stride, stride(film[0]), stride(film[1]),
                                                                        int(silu))
    assert sh.eps == pytest.approx(1e-6, rel=1e-7)
    y2 = gn._forward_kernel(x, gamma, beta, groups, 1e-6, silu, add, *film)
    assert recorder.calls[2][1][8] is a1[8] and recorder.calls[3][1][2] == y2.data_ptr()


def test_a_failed_launch_raises(monkeypatch):
    rec = Recorder(err=1)
    monkeypatch.setattr(gn, "_cuda_bindings", lambda: (lambda: None, lambda index: 0))
    monkeypatch.setattr(gn, "_kernel_fn", rec)
    before = gn.group_norm_act.launches
    with pytest.raises(RuntimeError, match="statistics launch failed"):
        gn._forward_kernel(torch.randn(1, 8, 64), torch.ones(64), torch.zeros(64), 32, 1e-5, True, None, None, None)
    assert len(rec.calls) == 1 and gn.group_norm_act.launches == before


def test_cuda_only_and_its_checks():
    x = torch.randn(2, 8, 64)
    with pytest.raises(ValueError, match="no kernel"):
        gn.group_norm_act(x, torch.ones(64), torch.zeros(64), 32)
    with pytest.raises(ValueError, match="fp32 with contiguous rows"):
        gn._row_stride(torch.randn(2, 64).t().contiguous().t(), 2, 64, "add")
    assert gn._row_stride(torch.randn(1, 64), 2, 64, "add") == 0


def _old_group_norm(x, scale, bias, groups, eps=1e-5):
    """`nn.blocks.group_norm` as it was before the kernel pair (plain tensors)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def _old_sharded_group_norm(x, scale, bias, groups, eps=1e-5):
    b, c = x.shape[0], x.shape[-1]
    xs = [p.float().reshape(b, -1, groups, c // groups) for p in x.parts]
    means, variances = spatial.group_stats(xs)
    return spatial.each(lambda p, xf, mean, var, g, h: (((xf - mean) * torch.rsqrt(var + eps)).reshape(p.shape)
                                                        * g.float() + h.float()).to(p.dtype),
                        x, xs, means, variances, scale, bias)


def _old_glue2(h, emb_out, film, gamma, beta, groups, norm=_old_group_norm):
    """ResBlock._glue2's composite before the kernel pair, without dropout."""
    eo = emb_out.to(h.dtype).reshape(emb_out.shape[:1] + (1,) * (h.ndim - 2) + emb_out.shape[1:])
    if film:
        scale, shift = eo.chunk(2, dim=-1)
        h = spatial.each(lambda g, a, b: g * (1 + a) + b, norm(h, gamma, beta, groups), scale, shift)
    else:
        h = norm(spatial.each(torch.add, h, eo), gamma, beta, groups)
    return spatial.each(F.silu, h)


def _parts_equal(a, b):
    a = a.parts if isinstance(a, spatial.Sharded) else [a]
    b = b.parts if isinstance(b, spatial.Sharded) else [b]
    return len(a) == len(b) and all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("sharded", [False, True], ids=["tensor", "sharded"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cpu_and_sharded_keep_the_composite(dtype, sharded):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 8, 6, 64, generator=g) * 3 + 1).to(dtype)
    gamma, beta = torch.randn(64, generator=g), torch.randn(64, generator=g)
    emb = torch.randn(2, 128, generator=g)
    if sharded:
        x = spatial.split(x, [torch.device("cpu")] * 2)
    old = _old_sharded_group_norm if sharded else _old_group_norm
    assert _parts_equal(blocks.group_norm(x, gamma, beta, 32), old(x, gamma, beta, 32))
    assert _parts_equal(blocks.group_norm(x, gamma, beta, 32, 1e-6), old(x, gamma, beta, 32, 1e-6))
    assert _parts_equal(blocks.group_norm(x, gamma, beta, 32, silu=True),
                        spatial.each(F.silu, old(x, gamma, beta, 32)))
    assert _parts_equal(blocks.group_norm(x, gamma, beta, 32, silu=True, add=emb[:, :64]),
                        _old_glue2(x, emb[:, :64], False, gamma, beta, 32, old))
    assert _parts_equal(blocks.group_norm(x, gamma, beta, 32, silu=True, film=emb.chunk(2, dim=-1)),
                        _old_glue2(x, emb, True, gamma, beta, 32, old))


@pytest.mark.parametrize("film", [False, True], ids=["add", "film"])
def test_resblock_glue_keeps_the_composite(film):
    torch.manual_seed(5)
    block = blocks.ResBlock(32, 64, 16, dims=2, use_scale_shift_norm=film)
    for p in block.parameters():
        torch.nn.init.normal_(p)
    h = torch.randn(2, 8, 8, 64).to(BF16)
    emb_out = torch.randn(2, 128 if film else 64)
    want = _old_glue2(h, emb_out, film, block.norm2_scale, block.norm2_bias, block.g2)
    assert torch.equal(block._glue2(h, emb_out, None), want)
    x = torch.randn(2, 8, 8, 32).to(BF16)
    assert torch.equal(block._glue1(x), F.silu(_old_group_norm(x, block.norm1_scale, block.norm1_bias, block.g1)))


def test_backward_recomputes_through_the_plain_version(monkeypatch):
    """The Function's gradients are the plain composite's (its forward routed
    to the plain version here, as the CPU has no kernel)."""
    monkeypatch.setattr(gn, "_forward_kernel",
                        lambda x, ga, be, groups, eps, silu, add, fs, fh: gn.group_norm_plain(
                            x, ga, be, groups, eps, silu, add, fs, fh))
    g = torch.Generator().manual_seed(9)
    leaves = [torch.randn(2, 5, 48, generator=g), torch.randn(48, generator=g), torch.randn(48, generator=g),
              torch.randn(2, 96, generator=g)]
    for t in leaves:
        t.requires_grad_(True)
    dy = torch.randn(2, 5, 48, generator=g)
    x, gamma, beta, emb = leaves
    y = gn._GroupNormAct.apply(x, gamma, beta, None, emb[:, :48], emb[:, 48:], 16, 1e-5, True)
    got = torch.autograd.grad(y, leaves, dy)
    want = torch.autograd.grad(gn.group_norm_plain(x, gamma, beta, 16, 1e-5, True, None, emb[:, :48], emb[:, 48:]),
                               leaves, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _tree_fold(parts):
    """The last block's fold of one group's tile partials [(n, mean, M2)]:
    lane l folds tiles l, l + 32, ... in order, then lane l takes lane l +
    16, 8, 4, 2, 1 (`__shfl_down_sync`); lane 0's result."""
    def chan(a, b):
        (n, m, q), (nb, mb, qb) = a, b
        if nb == 0:
            return a
        nn = n + nb
        d = mb - m
        w = nb / nn
        return nn, m + d * w, q + qb + d * d * n * w

    zero = (torch.tensor(0.0), torch.tensor(0.0), torch.tensor(0.0))
    lanes = [zero] * 32
    for t, p in enumerate(parts):
        lanes[t % 32] = chan(lanes[t % 32], p)
    for off in (16, 8, 4, 2, 1):
        lanes = [chan(lanes[i], lanes[i + off]) if i + off < 32 else lanes[i] for i in range(32)]
    return lanes[0]


def _kernel_fold(x, gamma, beta, groups, eps, add=None, film=None):
    """centre, scale, shift (B, C) fp32 as csrc/group_norm.cu computes them
    from x (B, S, C): each tile's per-channel (mean, M2) (the threads'
    Welford sums, merged, are the tile's two-pass moments in exact
    arithmetic), shifted by add and merged over a group's channels, then the
    tiles folded in the kernel's order."""
    b, s, c = x.shape
    cg = c // groups
    plan = gn.plan_group_norm(b, s, c, groups, x.dtype)
    xf = x.float()
    centre, scale, shift = (torch.empty(b, c) for _ in range(3))
    for bi in range(b):
        parts = []
        for t in range(plan.tiles):
            tile = xf[bi, t * plan.rows:(t + 1) * plan.rows]
            mean_c = tile.mean(dim=0) + (0 if add is None else add[bi])
            m2_c = ((tile - tile.mean(dim=0)) ** 2).sum(dim=0)
            mg = mean_c.reshape(groups, cg).sum(dim=1) / cg
            q = (m2_c.reshape(groups, cg) + tile.shape[0] * (mean_c.reshape(groups, cg) - mg[:, None]) ** 2).sum(1)
            parts.append((torch.full((groups,), float(tile.shape[0] * cg)), mg, q))
        for g in range(groups):
            n, m, q = _tree_fold([(p[0][g], p[1][g], p[2][g]) for p in parts])
            rstd = torch.rsqrt(q / n + eps)
            ch = slice(g * cg, (g + 1) * cg)
            sc, sh = rstd * gamma[ch], beta[ch].clone()
            if film is not None:
                f = 1 + film[0][bi, ch]
                sc, sh = sc * f, sh * f + film[1][bi, ch]
            centre[bi, ch] = m - (0 if add is None else add[bi, ch])
            scale[bi, ch], shift[bi, ch] = sc, sh
    return centre, scale, shift


def _float64_composite(x, gamma, beta, groups, eps, add=None, film=None):
    x = x.double() + (0 if add is None else add.double()[:, None])
    b, s, c = x.shape
    xg = x.reshape(b, s, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, s, c) * gamma.double() + beta.double()
    if film is not None:
        y = y * (1 + film[0].double()[:, None]) + film[1].double()[:, None]
    return y


@pytest.mark.parametrize("case", ["near_constant", "near_constant_add", "add_film", "tiles"])
def test_fold_matches_float64(case):
    """The kernel's statistics and fold, then its apply (x - centre) * scale +
    shift in fp32, within 1e-4 of a float64 composite (relative to max |y|;
    the fp32 two-pass composite reads 2.6e-5 on the near-constant field): on
    a field of 3 + 1e-3 noise, where E[x^2] - E[x]^2 in fp32 keeps no digit
    of the variance, with the add before the statistics, with FiLM, and over
    many tiles."""
    g = torch.Generator().manual_seed(21)
    b, s, c, groups = (2, 600, 64, 32) if case != "tiles" else (1, 5000, 48, 16)
    noise = torch.randn(b, s, c, generator=g, dtype=torch.float64)
    x = (3 + 1e-3 * noise if case.startswith("near") else 2 * noise).float()
    gamma, beta = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    add = (torch.randn(b, c, generator=g) if "add" in case else None)
    film = ((0.2 * torch.randn(b, c, generator=g), torch.randn(b, c, generator=g)) if "film" in case else None)
    eps = 1e-6 if case.startswith("near") else 1e-5
    assert gn.plan_group_norm(b, s, c, groups, F32).tiles > 32  # lanes fold more than one tile each
    centre, scale, shift = _kernel_fold(x, gamma, beta, groups, eps, add, film)
    y = (x - centre[:, None]) * scale[:, None] + shift[:, None]
    want = _float64_composite(x, gamma, beta, groups, eps, add, film)
    err = (y.double() - want).abs().max() / want.abs().max()
    assert err <= 1e-4, err
    if case == "near_constant":  # what the one-pass sum of squares would give here
        xg = x.reshape(b, s, groups, c // groups)
        var1 = (xg * xg).mean(dim=(1, 3)) - xg.mean(dim=(1, 3)) ** 2
        var64 = x.double().reshape(b, s, groups, c // groups).var(dim=(1, 3), correction=0)
        assert ((var1.double() - var64).abs() / var64).max() > 0.1


def _kernel_names():
    """(kernel, template instantiations) as csrc/group_norm.cu declares and
    launches them, and each as a profiler names it."""
    src = (ROOT / "jointimagegeneration_torch" / "csrc" / "group_norm.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(const (\w+) a\)", src)
    launcher = {"stats": kernels[0][0], "apply": kernels[1][0]}  # launch_stats<T, V> launches the first
    insts = {(launcher[f], t, v) for f, t, v in re.findall(r"launch_(stats|apply)<(__nv_bfloat16|float), (\d)>", src)}
    ns = "(anonymous namespace)::"  # as demangled; the profiler's trace names them without it (and "void")
    return kernels, {k: [name for kk, t, v in sorted(insts) if kk == k
                         for name in (f"void {ns}{k}<{t}, {v}>({ns}{arg})", f"{k}<{t}, {v}>({arg})")]
                     for k, arg in kernels}


def test_kernel_names_classify():
    kernels, named = _kernel_names()
    assert [k for k, _ in kernels] == ["gn_welford_reduce_kernel", "gn_affine_silu_elementwise_kernel"]
    want = {"gn_welford_reduce_kernel": "norm_reduce", "gn_affine_silu_elementwise_kernel": "elementwise"}
    for kernel, names in named.items():
        assert len(names) == 8  # bf16 and fp32, a 16-byte vector and one element, in both forms
        for name in names:
            for form in (name, re.sub(r"[^0-9A-Za-z_:]", "_", name)):  # as traced, and as the ledger shortens it
                assert bench_kind_of(form) == port_kind_of(form) == want[kernel], form
            assert not re.search(r"conv|stats_reduce_kernel|gemm|cutlass|cublas|flash|adam|foreach", name,
                                 re.IGNORECASE)


def _recording_plain(monkeypatch):
    """Sends every plain GroupNorm of the nn blocks through the kernel
    wrapper's CUDA path (with a Recorder for the C entry points) before the
    plain version computes it; returns the Recorder."""
    rec = Recorder()
    monkeypatch.setattr(gn, "_kernel_fn", rec)
    monkeypatch.setattr(gn, "_cuda_bindings", lambda: (lambda: None, lambda index: 0))

    def plain(x, *args):
        gn._forward_kernel(x, *args)
        return gn.group_norm_plain(x, *args)

    monkeypatch.setattr(blocks, "group_norm_plain", plain)
    return rec


def test_unet_calls_launch_twice_a_site(monkeypatch):
    """A UNet call of each cell's architecture (its channel_mult, res blocks,
    attention levels and heads; base width and spatial size cut) reaches 66
    GroupNorm sites, and each issues the pair: 132 launches a call."""
    from perfbench import program
    from perfbench.harness import load_json

    rec = _recording_plain(monkeypatch)
    cfg2 = dict(load_json("configs", "ldm_unet2d"), model_channels=16, num_head_channels=16)
    cfg3 = dict(load_json("configs", "ccdm_unet3d"), model_channels=16, num_head_channels=16,
                feature_cond_encoder={"type": "selfattn", "embed_dim": 32, "n_heads": 2, "model_depth": 1,
                                      "d_head": 16, "dropout": 0.2, "train": True})
    with torch.inference_mode():
        ldm = program.slice_ldm(cfg2, "cpu")
        x, cond = torch.randn(4, 16, 16, 1), torch.rand(4, 16, 16, 2)
        before = gn.group_norm_act.launches
        ldm.apply_model(x, torch.tensor([500] * 4), cond=cond)
        assert gn.group_norm_act.launches - before == 132
        assert [n for n, _ in rec.calls] == ["jig_gn_stats", "jig_gn_apply"] * 66
        ms = program.mask_sampler(cfg3, "cpu")
        xt = F.one_hot(torch.randint(0, 12, (1, 16, 16, 16)), 12).float()
        rec.calls.clear()
        before = gn.group_norm_act.launches
        ms.unet(xt, torch.tensor([500]), cond=torch.zeros(1, 16, 16, 16, 1), context=torch.randn(1, 4, 32))
        assert gn.group_norm_act.launches - before == 132 and len(rec.calls) == 132
    fp32 = [a[3].contents for n, a in rec.calls if n == "jig_gn_apply" and a[3].contents.dtype == 1]
    assert len(fp32) == 1 and fp32[0].silu == 1  # the fp32 out_norm, with SiLU
