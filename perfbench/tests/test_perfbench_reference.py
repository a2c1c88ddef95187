"""The plain reference against the port at tiny widths in fp32 (the UNet in 2D
and 3D, the DDIM step, the categorical posterior, one stage-2 train step and the
EMA rule), and the counts of operations against `FlopCounterMode` on the
reference.  CPU only: the port's kernels take their plain versions."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts
from perfbench.reference import diffusion as rd
from perfbench.reference import train as rt
from perfbench.reference.draws import Replay
from perfbench.reference.unet import refiner_forward, unet_forward
from perfbench.weights import make_weights

torch.set_num_threads(2)

CFG = {"model_channels": 32, "channel_mult": [1, 2, 2], "num_res_blocks": 1, "attention_resolutions": [2, 4],
       "num_head_channels": 16}


def _port_unet(dims, in_ch, out_ch, softmax, seed=3):
    from jointimagegeneration_torch.nn.unet import UNet

    unet = UNet(in_channels=in_ch, model_channels=CFG["model_channels"], out_channels=out_ch,
                num_res_blocks=CFG["num_res_blocks"], attention_resolutions=CFG["attention_resolutions"],
                channel_mult=CFG["channel_mult"], dims=dims, num_head_channels=CFG["num_head_channels"],
                softmax_output=softmax, device="cpu")
    weights = make_weights({n: p.shape for n, p in unet.named_parameters()}, seed, "cpu")
    unet.load_state_dict(weights)
    return unet, weights


@pytest.mark.parametrize("dims,spatial,in_ch,out_ch,softmax", [
    (2, (16, 16), 3, 1, False),
    (3, (8, 16, 16), 13, 12, True),
])
def test_unet_matches_port(dims, spatial, in_ch, out_ch, softmax):
    unet, weights = _port_unet(dims, in_ch, out_ch, softmax)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, *spatial, in_ch - 1, generator=g)
    cond = torch.randn(2, *spatial, 1, generator=g)
    t = torch.tensor([3.0, 517.0])
    with torch.no_grad():
        got = unet(x, t, cond=cond)
        ref = unet_forward(weights, CFG, x, t, cond, softmax=softmax)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


ENC = {"type": "selfattn", "embed_dim": 48, "n_heads": 2, "model_depth": 2, "d_head": 8, "dropout": 0.2,
       "train": True}


def _text_sampler():
    from jointimagegeneration_torch.models.mask_sampler import MaskSampler

    ms = MaskSampler.create(num_classes=12, model_channels=CFG["model_channels"],
                            channel_mult=tuple(CFG["channel_mult"]),
                            attention_resolutions=tuple(CFG["attention_resolutions"]),
                            num_res_blocks=CFG["num_res_blocks"], num_head_channels=CFG["num_head_channels"],
                            device="cpu", context_dim=ENC["embed_dim"], text_refiner=ENC)
    weights = make_weights({n: p.shape for n, p in ms.unet.named_parameters()}, 3, "cpu")
    refiner = make_weights({n: p.shape for n, p in ms.refiner.named_parameters()}, 4, "cpu")
    ms.unet.load_state_dict(weights)
    ms.refiner.load_state_dict(refiner)
    return ms, weights, refiner


def test_text_conditioned_unet_matches_port():
    """The published stage 1: the text refiner over report features, then
    the 3D UNet whose transformer sites cross-attend over its output."""
    ms, weights, refiner = _text_sampler()
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(2, 8, ENC["embed_dim"], generator=g)
    x = torch.randn(2, 8, 16, 16, 12, generator=g)
    cond = torch.randn(2, 8, 16, 16, 1, generator=g)
    t = torch.tensor([3.0, 517.0])
    with torch.no_grad():
        context, ref_context = ms.refine_context(feats), refiner_forward(refiner, ENC, feats)
        got = ms.unet(x, t, cond=cond, context=context)
        ref = unet_forward(weights, CFG, x, t, cond, softmax=True, context=ref_context)
    assert float((context - ref_context).abs().max()) <= 1e-5 * float(ref_context.abs().max())
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


def test_text_flops_match_flop_counter():
    _, weights, refiner = _text_sampler()
    feats, x = torch.randn(2, 8, ENC["embed_dim"]), torch.randn(2, 8, 16, 16, 12)
    with FlopCounterMode(display=False) as fc:
        context = refiner_forward(refiner, ENC, feats)
    assert counts.refiner_flops(ENC, 2, 8) == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        unet_forward(weights, CFG, x, torch.tensor([1.0, 2.0]), torch.randn(2, 8, 16, 16, 1), context=context)
    assert counts.unet_forward_flops(CFG, 2, (8, 16, 16), 13, 12, context=(8, ENC["embed_dim"])) == \
        fc.get_total_flops()


def test_ddim_schedule_and_step_match_port():
    from jointimagegeneration_torch.diffusion.ddim import DDIMParams, ddim_step
    from jointimagegeneration_torch.diffusion.gaussian import GaussianDiffusion
    from jointimagegeneration_torch.diffusion.noise import NoiseSource

    diff = GaussianDiffusion.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    params = DDIMParams.create(diff, 50, "uniform", 0.0)
    ts, a, a_prev = rd.ddim_schedule(rd.ldm_alphas_cumprod(1000, 0.0015, 0.0195), 50)
    np.testing.assert_array_equal(params.timesteps, ts)
    np.testing.assert_allclose(params.alphas, a, rtol=1e-6)
    np.testing.assert_allclose(params.alphas_prev, a_prev, rtol=1e-6)
    g = torch.Generator().manual_seed(1)
    x, e = torch.randn(2, 8, 8, 1, generator=g), torch.randn(2, 8, 8, 1, generator=g)
    for index in (0, 17, 49):
        got, _ = ddim_step(params, NoiseSource(0, "cpu"), x, e, index)
        ref = rd.ddim_update(x, e, float(a[index]), float(a_prev[index]))
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [1, 2, 250, 999, 1000])
def test_categorical_posterior_matches_port(t):
    from jointimagegeneration_torch.diffusion.categorical import CategoricalDiffusion

    diff = CategoricalDiffusion.create("cosine", 1000, 12)
    alphas, cumalphas = rd.ccdm_schedule(1000)
    np.testing.assert_allclose(diff.alphas.numpy(), alphas, rtol=1e-6)
    np.testing.assert_allclose(diff.cumalphas.numpy(), cumalphas, rtol=1e-6, atol=1e-12)
    g = torch.Generator().manual_seed(t)
    xt = rd.one_hot(torch.randint(0, 12, (2, 4, 4), generator=g), 12)
    x0 = torch.softmax(torch.randn(2, 4, 4, 12, generator=g), dim=-1)
    got = diff.theta_post_prob(xt, x0, torch.full((2,), t))
    ref = rd.categorical_posterior(xt, x0, t, alphas, cumalphas)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


def test_handoff_matches_port():
    from jointimagegeneration_torch.pipeline.two_stage import normalize_mask_channel, upsample_labels

    labels = torch.randint(0, 12, (2, 4, 8, 8), generator=torch.Generator().manual_seed(2))
    up = upsample_labels(labels, (8, 16, 16))
    assert torch.equal(up, rd.upsample_nearest(labels, (8, 16, 16)))
    assert torch.equal(normalize_mask_channel(up, 12)[..., 0], up.float() / 11)
    odd = rd.upsample_nearest(labels, (6, 12, 20))
    assert torch.equal(upsample_labels(labels, (6, 12, 20)), odd)


def test_replayed_draws_match_port():
    from jointimagegeneration_torch.diffusion.noise import NoiseSource

    noise, replay = NoiseSource(2**31 + 7, "cpu"), Replay(2**31 + 7, "cpu")
    for draw in ("normal", "gumbel", "randint"):
        args = (0, 1000, (3,)) if draw == "randint" else ((4, 5),)
        assert torch.equal(getattr(noise, draw)(*args), getattr(replay, draw)(*args))


def test_train_step_matches_port():
    """One stage-2 step of the port in fp32 (loss and every leaf's gradient)
    against the reference's, and one AdamW update against the port's
    optimizer."""
    from jointimagegeneration_torch.diffusion.noise import NoiseSource
    from jointimagegeneration_torch.models.slice_ldm import SliceLDM
    from jointimagegeneration_torch.train.optim import build_optimizer
    from jointimagegeneration_torch.train.steps import ldm_loss

    g = torch.Generator().manual_seed(4)
    kw = dict(model_channels=32, channel_mult=(1, 2), attention_resolutions=(2,), num_res_blocks=1,
              num_head_channels=16, device="cpu")
    model = SliceLDM.create(**kw)
    cfg = {"timesteps": 1000, "linear_start": 0.0015, "linear_end": 0.0195}
    batch = {"image": torch.rand(2, 16, 16, 1, generator=g), "cond": torch.rand(2, 16, 16, 2, generator=g)}
    cfg.update({k: list(v) if isinstance(v, tuple) else v for k, v in kw.items() if k != "device"})
    start = make_weights({n: p.shape for n, p in model.unet.named_parameters()}, 5, "cpu")
    model.unet.load_state_dict(start)
    names = [n for n, _ in model.named_parameters()]
    loss = ldm_loss(model, NoiseSource(9, "cpu"), batch)[0]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    params = {n: start[n].clone().requires_grad_(True) for n in names}
    rloss = rt.ldm_loss(params, cfg, batch, Replay(9, "cpu"))
    rgrads = torch.autograd.grad(rloss, [params[n] for n in names])
    assert abs(float(loss.detach()) - float(rloss.detach())) <= 1e-5 * abs(float(rloss.detach()))
    top = max(float(b.abs().max()) for b in rgrads)
    for n, a, b in zip(names, grads, rgrads):  # leaves near zero (a key's bias) by the largest gradient
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-2 * top), n
    opt = build_optimizer(model.named_parameters(), "AdamW", 1e-3)
    opt.step([b.detach().clone() for b in rgrads])  # the optimizers alone, on the same gradients
    ref_opt = rt.AdamW({n: params[n].detach() for n in names})
    ref_opt.step(dict(zip(names, [b.detach() for b in rgrads])), 1e-3)
    for (n, p), q in zip(model.named_parameters(), ref_opt.params.values()):
        torch.testing.assert_close(p.detach(), q, rtol=1e-5, atol=2e-6, msg=n)


@pytest.mark.parametrize("warmup", [True, False])
def test_ema_rule_matches_port(warmup):
    """Three EMA updates of the port's train state against the reference's
    rule, on the same parameters."""
    from jointimagegeneration_torch.train.optim import build_optimizer
    from jointimagegeneration_torch.train.state import EMATrainState

    g = torch.Generator().manual_seed(6)
    p = torch.nn.Parameter(torch.randn(64, generator=g))
    state = EMATrainState(build_optimizer([("w", p)], "AdamW", 1e-2), ema_decay=0.9, ema_warmup=warmup)
    start = p.detach().clone()
    ema, rule = {"w": start.double()}, rt.Ema(0.9, warmup)
    for i in range(3):
        state.apply_gradients({"w": torch.randn(64, generator=g)})
        rule.update(ema, {"w": p.detach().double()}, i)
    torch.testing.assert_close(state.ema[0].double(), ema["w"], rtol=0, atol=1e-6)
    assert float((ema["w"] - start.double()).norm()) > 0


@pytest.mark.parametrize("spatial", [(16, 16), (8, 16, 16)])
def test_flops_match_flop_counter(spatial):
    in_ch, out_ch = (3, 1) if len(spatial) == 2 else (13, 12)
    p = make_weights({n: s for n, s in _shapes(len(spatial), in_ch, out_ch).items()}, 0, "cpu")
    x = torch.randn(2, *spatial, in_ch - 1)
    with FlopCounterMode(display=False) as fc:
        unet_forward(p, CFG, x, torch.tensor([1.0, 2.0]), torch.randn(2, *spatial, 1))
    assert counts.unet_forward_flops(CFG, 2, spatial, in_ch, out_ch) == fc.get_total_flops()


def _shapes(dims, in_ch, out_ch):
    unet, _ = _port_unet(dims, in_ch, out_ch, False)
    return {n: p.shape for n, p in unet.named_parameters()}


def test_published_widths_counts():
    """The per-forward counts at the cells' widths (1.122 TFLOP at 256^2,
    4.629 at 512^2, 6.324 for the 3D UNet at 64x128x128, each at b = 1, as
    `FlopCounterMode` reads the port's UNets), and the flash sites per
    forward."""
    ldm = {"model_channels": 128, "channel_mult": [1, 2, 4, 4, 5], "num_res_blocks": 2,
           "attention_resolutions": [32, 16, 8], "num_head_channels": 32}
    ccdm = dict(ldm, model_channels=64, channel_mult=[1, 2, 2, 4, 5])
    assert math.isclose(counts.unet_forward_flops(ldm, 1, (256, 256), 3, 1) / 1e12, 1.122, abs_tol=5e-4)
    assert math.isclose(counts.unet_forward_flops(ldm, 1, (512, 512), 3, 1) / 1e12, 4.629, abs_tol=5e-4)
    assert math.isclose(counts.unet_forward_flops(ccdm, 1, (64, 128, 128), 13, 12) / 1e12, 6.324, abs_tol=5e-4)
    assert counts.flash_sites(ldm, 4, (256, 256)) == [(64, 1024, 1024, 32)] * 5
    assert counts.flash_sites(ldm, 1, (512, 512)) == [(16, 4096, 4096, 32)] * 2 + [(20, 1024, 1024, 32)] * 6 + [
        (16, 4096, 4096, 32)] * 3
    assert counts.flash_sites(ccdm, 1, (64, 128, 128)) == [(8, 2048, 2048, 32)] * 5
    assert counts.flash_sites(ccdm, 1, (64, 128, 128), 512) == [(8, 2048, 2048, 32), (8, 2048, 512, 32)] * 5
    enc = {"embed_dim": 768, "n_heads": 8, "model_depth": 4, "d_head": 64}
    assert counts.refiner_flash_sites(enc, 1, 512) == [(8, 512, 512, 64)] * 8


def test_roofline_bounds():
    """The forward at (64, 1024, 32) is bound by its operations: 4 BH T^2 D
    over 989 TFLOP/s; a site with one key is bound by its bytes."""
    assert math.isclose(counts.flash_fwd_roofline_s(64, 1024, 1024, 32), 4 * 64 * 1024 ** 2 * 32 / 989e12)
    b = counts.flash_fwd_roofline_s(16, 1024, 1, 32)
    assert math.isclose(b, (2 * 32 * 16 * (2 * 1024 + 2)) / 3.35e12 + 4 * 16 * 1024 / 3.35e12)
    assert counts.flash_bwd_roofline_s(64, 1024, 1024, 32) > 2 * counts.flash_fwd_roofline_s(64, 1024, 1024, 32)
