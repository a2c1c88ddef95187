"""PyTorch port: the fp32 flash forward (`flash_fwd_f32_kernel` and its split
merge, csrc/flash_fwd.cu) and the fp32 conv (`conv3d_ffma_kernel` and its
split-K reduce, csrc/conv3d.cu), checked on the CPU.

  * Their launch plans at every fp32 shape `chip_smoke.py` runs: the key
    splits of the forward partition its key tiles, the merge launches where
    it splits, the wrappers issue the planned launches with the plan's
    arguments (through recording stand-ins for the C entry points).
  * Float64 emulations of each kernel's schedule held against the plain
    versions within 1e-12: the forward's per-split online softmax over key
    tiles (running max from -1e30, keys past Tk at -inf, splits that see no
    key) then the merge; the conv's K iterations (chunks of 16 channels x
    (dz, dy) rows of 3 taps, the prologue on in-bounds halo elements only)
    per K split, then the ordered split-K sum and the epilogue.
  * The merge's plain version on its own, against a log-sum-exp evaluation.
  * The port's plain versions against the JAX package's fp32 functions (the
    Pallas kernels in interpret mode) within 1e-5: the flash forward's O and
    LSE absolute on unit-variance inputs, the conv's output and stats
    relative to their largest magnitude (fp32 sums in another order).
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jointimagegeneration_torch.ops import conv3d as tconv
from jointimagegeneration_torch.ops import flash_attention as tflash
from jointimagegeneration_tpu.ops.pallas import fused_resblock as jfr
from jointimagegeneration_tpu.ops.pallas.flash_attention import _flash_forward

CSRC = Path(tflash.__file__).resolve().parents[1] / "csrc"
JAX_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_fwd_shapes():
    """(BH, Tq, Tk, D) of every fp32 forward chip_smoke.py runs (rows, text
    rows, edge shapes) and of the fp32 reference phases' attention sites."""
    rows = [s for s, dtype, _ in chip_smoke._full_shapes(chip_smoke.FWD_SHAPES) if dtype == torch.float32]
    rows += [s for s, dtype in chip_smoke.FWD_EDGE_SHAPES if dtype == torch.float32]
    return rows + [(4, 1024, 1024, 16), (8, 1024, 1024, 16), (4, 512, 512, 16), (2, 512, 512, 64), (1, 1024, 1024, 16)]


FWD = [pytest.param(s, id="x".join(map(str, s))) for s in _f32_fwd_shapes()]


@pytest.mark.parametrize("shape", FWD)
def test_fp32_forward_splits_partition_the_key_tiles(shape):
    bh, tq, tk, d = shape
    plan = tflash.plan_flash_fwd(bh, tq, tk, d, torch.float32)
    n_kt = -(-tk // plan.rows)
    starts = [s * n_kt // plan.splits for s in range(plan.splits + 1)]  # the kernel's split_start
    assert starts[0] == 0 and starts[-1] == n_kt
    assert all(lo < hi for lo, hi in zip(starts, starts[1:]))  # no split is empty
    blocks = -(-tq // 64) * bh * (plan.head_width // plan.chunk)
    assert plan.grid == blocks * plan.splits
    assert plan.splits == tflash.f32_bwd_splits(blocks, n_kt)
    assert plan.merge_launches == int(plan.splits > 1)


def test_fp32_forward_source_agrees_with_the_planner():
    text = (CSRC / "flash_fwd.cu").read_text()
    assert "return HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);" in text  # f32_fwd_rows
    assert "p.splits > (p.tk + rt - 1) / rt" in text  # launch_f32<HD> checks the splits on the template's rows
    assert [tflash.f32_fwd_rows(hd) for hd in (16, 32, 64, 128, 256)] == [64, 64, 64, 32, 16]
    assert "kF32Threads = 256" in (CSRC / "flash_common.cuh").read_text() and tflash.F32_THREADS == 256


@pytest.mark.parametrize("shape", [pytest.param((2, 130, 200, 64), id="split"), pytest.param((1, 7, 3, 8), id="one"),
                                   pytest.param((1, 7, 3, 5), id="padded")])
def test_fp32_forward_issues_the_planned_launches(shape, monkeypatch):
    """`flash_forward`'s kernel path on stand-in entry points: the forward
    entry with the plan's (warpgroups 0, splits, smem_bytes) and a workspace
    where it splits, then one merge; D % 4 != 0 runs on zero-padded copies."""
    bh, tq, tk, d = shape
    calls, merges = [], []
    monkeypatch.setattr(tflash, "_call", lambda name, args, device, what: calls.append((name, args)))
    monkeypatch.setattr(tflash, "flash_fwd_merge", lambda *t: merges.append([tuple(x.shape) for x in t]))
    q, k, v = torch.randn(bh, tq, d), torch.randn(bh, tk, d), torch.randn(bh, tk, d)
    before = tflash.flash_forward.launches
    o, lse = tflash._tma_padded(tflash._forward_kernel, q, k, v)
    dp = d + (-d % 4)
    plan = tflash.plan_flash_fwd(bh, tq, tk, dp, torch.float32)
    assert tflash.flash_forward.launches - before == 1
    (name, args), = calls
    assert name == "jig_flash_fwd" and len(args) + 1 == len(tflash._ENTRY_POINTS[name][1])
    assert args[7:] == (bh, tq, tk, dp, 1, 0, plan.splits, plan.smem_bytes)
    assert (args[5] is None) == (args[6] is None) == (plan.splits == 1)
    assert merges == ([[(plan.splits, bh, tq, dp), (plan.splits, bh, tq, 2), (bh, tq, dp), (bh, tq, 1)]]
                      if plan.splits > 1 else [])
    assert o.shape == (bh, tq, d) and lse.shape == (bh, tq, 1)


def _forward_splits64(q, k, v, rows, splits):
    """The fp32 kernel's arithmetic in float64 without its roundings: split s
    walks key tiles [s n / splits, (s + 1) n / splits) of `rows` keys, each
    one online-softmax step (keys past Tk at -inf, m from -1e30, O and l
    rescaled once per tile); returns the splits' (O unnormalised, (m, l))."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    n = -(-tk // rows)
    o_parts, ml_parts = [], []
    for s in range(splits):
        m = np.full((bh, tq, 1), -1e30)
        l = np.zeros((bh, tq, 1))
        o = np.zeros((bh, tq, d))
        for j in range(s * n // splits, (s + 1) * n // splits):
            kt, vt = np.zeros((bh, rows, d)), np.zeros((bh, rows, d))
            kt[:, :min(rows, tk - rows * j)] = k[:, rows * j:rows * j + rows]
            vt[:, :min(rows, tk - rows * j)] = v[:, rows * j:rows * j + rows]
            sc = q @ kt.transpose(0, 2, 1)
            sc[:, :, tk - rows * j:] = -np.inf
            m_new = np.maximum(m, sc.max(-1, keepdims=True))
            scale = np.exp2((m - m_new) * math.log2(math.e))
            p = np.exp2(sc * math.log2(math.e) - m_new * math.log2(math.e))
            o, l, m = o * scale + p @ vt, l * scale + p.sum(-1, keepdims=True), m_new
        o_parts.append(o)
        ml_parts.append(np.concatenate([m, l], axis=-1))
    return torch.from_numpy(np.stack(o_parts)), torch.from_numpy(np.stack(ml_parts))


@pytest.mark.parametrize("tq,tk,rows,splits", [
    (70, 200, 64, 4),    # a ragged last tile (8 keys), one tile a split
    (100, 77, 64, 2),    # two tiles, the second ragged
    (33, 64, 64, 3),     # one tile: two splits see no key
    (65, 1000, 64, 16),  # 16 tiles, one each, the last of 40 keys
    (40, 77, 16, 5),     # uneven ranges of 16-key tiles
])
def test_fp32_forward_splits_and_merge_match_plain(tq, tk, rows, splits):
    rs = np.random.RandomState(tq + tk + splits)
    q = rs.randn(2, tq, 24) / math.sqrt(24) * 3.0
    k, v = rs.randn(2, tk, 24), rs.randn(2, tk, 24)
    o_parts, ml_parts = _forward_splits64(q, k, v, rows, splits)
    if -(-tk // rows) < splits:  # the empty splits' states are exactly the init
        empty = ml_parts[:, 0, 0, 1] == 0
        assert bool(empty.any()) and bool((ml_parts[empty][..., 0] == -1e30).all())
    o, lse = tflash.flash_fwd_merge_plain(o_parts, ml_parts)
    want_o, want_lse = tflash.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("shape", [pytest.param((8, 512, 512, 64), id="refiner512"),
                                   pytest.param((8, 640, 640, 64), id="refiner640")])
def test_fp32_forward_planned_schedule_matches_plain(shape):
    """The refiner rows' own schedule (the plan's rows and splits), on one
    head of their length and width."""
    _, tq, tk, d = shape
    plan = tflash.plan_flash_fwd(*shape, torch.float32)
    assert plan.splits > 1
    rs = np.random.RandomState(tq)
    q = rs.randn(1, tq, d) / math.sqrt(d) * 2.0
    k, v = rs.randn(1, tk, d), rs.randn(1, tk, d)
    o, lse = tflash.flash_fwd_merge_plain(*_forward_splits64(q, k, v, plan.rows, plan.splits))
    want_o, want_lse = tflash.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-12, rtol=0)


def test_merge_plain_against_log_sum_exp():
    """O = sum_s O_s e^(m_s) / sum_s l_s e^(m_s) and LSE = log sum_s l_s
    e^(m_s), evaluated with numpy's logaddexp; a split with (m, l, O) =
    (-1e30, 0, 0) adds nothing; the CPU wrapper writes the plain result into
    its outputs and rejects a workspace that does not split them."""
    rs = np.random.RandomState(7)
    splits, bh, tq, d = 3, 2, 5, 8
    o_parts = rs.randn(splits, bh, tq, d)
    m = rs.randn(splits, bh, tq) * 3
    l = rs.rand(splits, bh, tq) + 0.1
    ml = np.stack([m, l], axis=-1)
    o, lse = tflash.flash_fwd_merge_plain(torch.from_numpy(o_parts), torch.from_numpy(ml))
    log_w = m + np.log(l)  # log(l_s e^(m_s))
    want_lse = np.logaddexp.reduce(log_w, axis=0)
    want_o = (o_parts * np.exp(m - want_lse)[..., None]).sum(0)
    np.testing.assert_allclose(lse.numpy()[..., 0], want_lse, atol=1e-12, rtol=0)
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-12, rtol=0)
    empty_o = np.concatenate([o_parts, np.zeros((1, bh, tq, d))])
    empty_ml = np.concatenate([ml, np.stack([np.full((1, bh, tq), -1e30), np.zeros((1, bh, tq))], -1)])
    o2, lse2 = tflash.flash_fwd_merge_plain(torch.from_numpy(empty_o), torch.from_numpy(empty_ml))
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    parts32, ml32 = torch.from_numpy(o_parts).float(), torch.from_numpy(ml).float()
    out, out_lse = torch.empty(bh, tq, d), torch.empty(bh, tq, 1)
    got = tflash.flash_fwd_merge(parts32, ml32, out, out_lse)
    assert got[0] is out and got[1] is out_lse
    want32 = tflash.flash_fwd_merge_plain(parts32, ml32)
    assert torch.equal(out, want32[0]) and torch.equal(out_lse, want32[1])
    with pytest.raises(ValueError):
        tflash.flash_fwd_merge(parts32[:1], ml32[:1], out, out_lse)  # one split: nothing to merge
    with pytest.raises(ValueError):
        tflash.flash_fwd_merge(parts32, ml32, torch.empty(bh, tq, d + 1), out_lse)


@pytest.mark.parametrize("bh,tq,tk,d", [(2, 256, 128, 64), (1, 128, 384, 16), (2, 256, 256, 32)])
def test_fp32_forward_plain_matches_jax(bh, tq, tk, d):
    """The port's forward on the CPU (the kernel's plain version) against the
    JAX package's `_flash_forward` (Pallas, interpret mode), fp32."""
    rs = np.random.RandomState(bh * tq + d)
    q = (rs.randn(bh, tq, d) / math.sqrt(d)).astype(np.float32)
    k, v = rs.randn(bh, tk, d).astype(np.float32), rs.randn(bh, tk, d).astype(np.float32)
    o_j, lse_j = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128)
    o_t, lse_t = tflash.flash_forward(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=JAX_TOL, rtol=0)


# ---- the fp32 conv ----

def _conv_inputs(shape, cout, flags, seed=0):
    rs = np.random.RandomState(seed)
    cin = shape[-1]
    x = rs.randn(*shape)
    k = rs.randn(3, 3, 3, cin, cout) / math.sqrt(27 * cin)
    kw = {"want_stats": bool(flags & 8), "activate": bool(flags & 16)}
    if flags & 1:
        kw["scale"], kw["shift"] = rs.rand(cin) + 0.5, rs.randn(cin) * 0.5
    if flags & 2:
        kw["bias"] = rs.randn(cout) * 0.1
    if flags & 4:
        kw["residual"] = rs.randn(*shape[:4], cout)
    return x, k, kw


def _silu(v):
    return v / (1.0 + np.exp(-v))


def _conv_plain64(x, k, scale=None, shift=None, bias=None, residual=None, want_stats=False, activate=False):
    """`conv3d_plain`'s steps in float64 (it computes in fp32)."""
    xt = torch.from_numpy(_silu(x * scale + shift) if scale is not None else x)
    y = torch.nn.functional.conv3d(xt.movedim(-1, 1), torch.from_numpy(k).permute(4, 3, 0, 1, 2),
                                   padding=1).movedim(1, -1).numpy()
    y = y + (bias if bias is not None else 0) + (residual if residual is not None else 0)
    flat = y.reshape(-1, y.shape[-1])
    stats = np.stack([flat.sum(0), (flat * flat).sum(0)])
    return (_silu(y) if activate else y), stats


def _conv_splits64(x, k, plan, scale=None, shift=None, bias=None, residual=None, want_stats=False,
                   activate=False):
    """The fp32 conv kernel's arithmetic in float64: per K split, its
    iterations it = (chunk c = it // 9, row r = it % 9 = 3 dz + dy); each
    takes the chunk's halo (the prologue on in-bounds elements, the padding
    and channels past Cin 0) and adds its three taps (dz, dy, dx = 0, 1, 2);
    then the splits' partials summed in split order, + bias + residual, the
    stats of that value, SiLU."""
    b, d, h, w, cin = x.shape
    cout, kc = k.shape[-1], plan.chunk
    t = _silu(x * scale + shift) if scale is not None else x
    n_ch = -(-cin // kc)
    halo = np.zeros((b, d + 2, h + 2, w + 2, n_ch * kc))
    halo[:, 1:-1, 1:-1, 1:-1, :cin] = t  # in-bounds elements only
    wk = np.zeros((3, 3, 3, n_ch * kc, cout))
    wk[:, :, :, :cin] = k
    parts = []
    for lo, hi in plan.split_ranges:
        acc = np.zeros((b, d, h, w, cout))
        for it in range(lo, hi):
            c, r = it // 9, it % 9
            dz, dy = r // 3, r % 3
            for dx in range(3):
                win = halo[:, dz:dz + d, dy:dy + h, dx:dx + w, c * kc:(c + 1) * kc]
                acc += win @ wk[dz, dy, dx, c * kc:(c + 1) * kc]
        parts.append(acc)
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    y = y + (bias if bias is not None else 0) + (residual if residual is not None else 0)
    flat = y.reshape(-1, cout)
    stats = np.stack([flat.sum(0), (flat * flat).sum(0)])
    return (_silu(y) if activate else y), stats


CONV = [((1, 5, 9, 10, 20), 12, 1 | 2 | 8),      # 2 chunks (the second of 4 channels), ragged tiles
        ((1, 3, 8, 10, 8), 12, 1 | 2 | 8),       # chip_smoke's edge shapes, split by the planner
        ((2, 3, 8, 8, 16), 16, 16),
        ((1, 2, 8, 8, 4), 8, 1 | 2 | 4),
        ((1, 5, 16, 24, 40), 72, 2 | 4 | 8),
        ((1, 4, 8, 8, 40), 24, 1 | 2 | 4 | 8)]   # a level-4-like volume, 3 chunks, many splits


@pytest.mark.parametrize("shape,cout,flags", [pytest.param(*c, id=f"{'x'.join(map(str, c[0]))}to{c[1]}-f{c[2]}")
                                              for c in CONV])
def test_fp32_conv_split_k_schedule_matches_plain(shape, cout, flags):
    plan = tconv.plan_conv3d(*shape, cout, torch.float32, flags)
    assert plan.chunk == 16 and plan.tps == 3
    x, k, kw = _conv_inputs(shape, cout, flags)
    got, got_stats = _conv_splits64(x, k, plan, **kw)
    want, want_stats = _conv_plain64(x, k, **kw)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got_stats, want_stats, atol=1e-12 * max(1.0, np.abs(want_stats).max()), rtol=0)
    # every other split count the kernel takes sums the same
    for splits in (1, 2, 5):
        n_it = 9 * -(-shape[-1] // 16)
        if splits <= n_it:
            ranges = tuple((s * n_it // splits, (s + 1) * n_it // splits) for s in range(splits))
            alt = _conv_splits64(x, k, type("P", (), {"chunk": 16, "split_ranges": ranges})(), **kw)[0]
            np.testing.assert_allclose(alt, want, atol=1e-12, rtol=0)
    # and the port's fp32 plain version agrees to fp32's summation order
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.float32))
    out = tconv.conv3d_plain(t(x), t(k), t(kw.get("scale")), t(kw.get("shift")), t(kw.get("bias")),
                             t(kw.get("residual")), kw["want_stats"], kw["activate"])
    out = out[0] if kw["want_stats"] else out
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("shape,cout,flags", [((1, 4, 8, 8, 640), 320, 11), ((1, 3, 8, 10, 8), 12, 11),
                                              ((1, 32, 64, 64, 128), 128, 11)])
def test_fp32_conv_wrapper_issues_the_planned_launches(shape, cout, flags):
    """The conv, the fp32 split-K reduce (dtype code 1) where the plan splits,
    then the stats reduce over the plan's stats rows."""
    plan = tconv.plan_conv3d(*shape, cout, torch.float32, flags)
    calls = []

    def fn(name):
        return lambda *args: calls.append((name, args)) or 0

    ptrs = {k: i + 1 for i, k in enumerate(("x", "wt", "scale", "shift", "bias", "residual", "out", "partial",
                                            "split", "stats"))}
    tconv._launch_plan(plan, fn, ptrs, shape, cout, torch.float32, flags, 0)
    names = [n for n, _ in calls]
    assert names == ["jig_conv3d"] + ["jig_conv3d_splitk_reduce"] * (plan.splits > 1) + ["jig_conv3d_stats_reduce"]
    assert calls[0][1][15:23] == (1, flags, 4, 64, 3, 2, plan.splits, plan.smem_bytes)
    if plan.splits > 1:
        red = calls[1][1]
        assert len(red) == len(tconv._ARGTYPES["jig_conv3d_splitk_reduce"])
        assert red[5:10] == (math.prod(shape[:4]), cout, plan.splits, flags, 1)
    assert calls[-1][1][2:4] == (plan.stats_shape[0], 2 * cout)


def test_fp32_conv_source_agrees_with_the_planner():
    text = (CSRC / "conv3d.cu").read_text()
    for const in ("kFTZ = 4;", "kFBN = 64;", "kFKC = 16;", "kFThreads = 256;", "kFStages = 2;"):
        assert f"constexpr int {const}" in text
    halo_plane = (4 + 2) * 10 * 12 + 4
    assert tconv._F32_SMEM == 4 * (2 * 3 * 16 * 64 + 16 * halo_plane + 6 * 10 * 10 * 16) <= tconv.SMEM_LIMIT
    assert 2 * (tconv._F32_SMEM + 1024) <= 233_472  # two blocks on an SM


@pytest.mark.parametrize("mode", ["affine", "preactivated"])
@pytest.mark.parametrize("bias,residual,want_stats", [(True, False, True), (True, True, False)])
def test_fp32_conv_plain_matches_jax(bias, residual, want_stats, mode):
    """The port's fused conv functions on the CPU (the kernel's plain
    version) against the JAX package's (Pallas, interpret mode), fp32, at
    Cin 24 (one and a half of the kernel's channel chunks)."""
    from jointimagegeneration_torch.ops import fused_resblock as tfr

    shape, cout = (1, 4, 8, 8, 24), 16
    flags = (1 if mode == "affine" else 0) | (2 if bias else 0) | (4 if residual else 0) | (8 if want_stats else 0)
    x, k, kw = _conv_inputs(shape, cout, flags, seed=3)
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    x, k = f32(x), f32(k)
    sc, sh, b, r = (f32(kw.get(n)) for n in ("scale", "shift", "bias", "residual"))
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    jfr._FORCE_PALLAS[0] = True
    try:
        if mode == "affine":
            want = jfr.fused_affine_silu_conv3d(j(x), j(k), j(sc), j(sh), j(b), j(r), want_stats, 4)
        else:
            want = jfr.fused_conv3d(j(x), j(k), j(b), j(r), want_stats, 4)
    finally:
        jfr._FORCE_PALLAS[0] = False
    if mode == "affine":
        got = tfr.fused_affine_silu_conv3d(t(x), t(k), t(sc), t(sh), t(b), t(r), want_stats, 4)
    else:
        got = tfr.fused_conv3d(t(x), t(k), t(b), t(r), want_stats, 4)
    got, want = (got, want) if want_stats else ((got,), (want,))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=JAX_TOL * np.abs(w).max(), rtol=0)
