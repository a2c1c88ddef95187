"""PyTorch port: the latent `_ae` route against the benchmark's plain fp32
reference (`perfbench/reference/vae.py` with `reference/unet.py` and
`reference/diffusion.py`), its operation counts, and its spans and counters,
on the CPU at small sizes with seeded weights (`perfbench/weights.py`).

Tolerances, each beside its test: the port and the reference both compute in
fp32 and differ only in the order of their sums (the port's channels-last
convolutions and GroupNorm statistics, its q and k scaled by d^-1/4 each
where the reference scales the logits by 1/sqrt(d)), so one AE call agrees to
1e-5 of its largest output; a whole slice step compounds that over the cond
encode, the DDIM chain and the decode, and the min-max stretches the slice
onto [0, 1], so a slice agrees to 1e-4 in [0, 1] units."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from jointimagegeneration_torch.core import logging as spans
from jointimagegeneration_torch.diffusion.ddim import DDIMParams
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.models import latent_ldm
from jointimagegeneration_torch.models.autoencoder import AutoencoderKL
from jointimagegeneration_torch.models.latent_ldm import LatentSliceLDM
from jointimagegeneration_torch.nn.vae import make_attn
from jointimagegeneration_torch.ops import attention as port_attention
from jointimagegeneration_torch.ops import flash_attention
from perfbench import ae_counts, ae_readers
from perfbench.reference import diffusion as rd
from perfbench.reference import vae
from perfbench.reference.draws import Replay
from perfbench.reference.unet import Exact, unet_forward
from perfbench.weights import make_weights


def _section(ch, mult, nrb, attn, in_ch, out_ch, res, embed=4, z=4):
    return {"embed_dim": embed, "ddconfig": {"ch": ch, "ch_mult": list(mult), "num_res_blocks": nrb,
                                             "attn_resolutions": list(attn), "z_channels": z, "in_channels": in_ch,
                                             "out_ch": out_ch, "resolution": res}}


# the published pair's form (cond: 2 channels in, image: 1), cut to CPU sizes with >= 2 channels a
# GroupNorm group; a placed attention site beside the mid one
COND = _section(64, (1, 1, 2), 1, (16,), 2, 2, 32)
IMAGE = _section(64, (1, 2, 2), 2, (8,), 1, 1, 32)
UNET = {"model_channels": 16, "channel_mult": [1, 2], "num_res_blocks": 1, "attention_resolutions": [2],
        "num_head_channels": 8, "image_channels": 4, "cond_channels": 4, "timesteps": 1000, "linear_start": 0.0015,
        "linear_end": 0.0195}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.trace_spans(False)
    spans.reset_spans()
    yield
    spans.trace_spans(False)
    spans.reset_spans()


def _ae(section, seed):
    dd = section["ddconfig"]
    ae = AutoencoderKL(embed_dim=section["embed_dim"], ch=dd["ch"], ch_mult=dd["ch_mult"],
                       num_res_blocks=dd["num_res_blocks"], attn_resolutions=dd["attn_resolutions"],
                       z_channels=dd["z_channels"], in_channels=dd["in_channels"], out_ch=dd["out_ch"],
                       resolution=dd["resolution"], device="cpu")
    weights = make_weights({n: p.shape for n, p in ae.named_parameters()}, seed, "cpu")
    ae.load_state_dict(weights)
    return ae.eval().requires_grad_(False), weights


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("section", [COND, IMAGE], ids=["cond", "image"])
def test_encode_matches_reference(section):
    ae, weights = _ae(section, 11)
    x = torch.rand(2, 32, 32, section["ddconfig"]["in_channels"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, ref = ae.encode(x).mode(), vae.encode(weights, section, x)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5  # fp32 both, sums in another order


@pytest.mark.parametrize("section", [COND, IMAGE], ids=["cond", "image"])
def test_decode_matches_reference(section):
    ae, weights = _ae(section, 12)
    f = ae.downsample_factor
    z = torch.randn(2, 32 // f, 32 // f, section["embed_dim"], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, ref = ae.decode(z), vae.decode(weights, section, z)
    assert got.shape == ref.shape == (2, 32, 32, section["ddconfig"]["out_ch"])
    assert _rel(got, ref) <= 1e-5  # fp32 both, sums in another order


@pytest.mark.parametrize("width", [384, 512])
def test_one_head_mid_attention_at_published_width(width):
    """The cond stage's (384) and the first stage's (512) mid attention at
    their widths over 8 x 8 tokens (4,096 at 512^2): one head of width C,
    which the flash rule refuses, so the plain path runs it, once."""
    block = make_attn("vanilla", width, 2, device="cpu")
    weights = make_weights({f"mid_attn.{n}": p.shape for n, p in block.named_parameters()}, width, "cpu")
    block.load_state_dict({n[len("mid_attn."):]: w for n, w in weights.items()})
    x = torch.randn(2, 8, 8, width, generator=torch.Generator().manual_seed(width))
    plain, flash = port_attention.plain_attention.launches, flash_attention.flash_forward.launches
    with torch.no_grad():
        got = block(x)
    ref = vae.attention(Exact(), weights, "mid_attn", x.movedim(-1, 1)).movedim(1, -1)
    assert port_attention.plain_attention.launches - plain == 1
    assert flash_attention.flash_forward.launches == flash
    assert _rel(got - x, ref - x) <= 1e-5  # the attention's own output, fp32 both


@pytest.mark.parametrize("section,which", [(COND, "encode"), (IMAGE, "encode"), (COND, "decode"),
                                           (IMAGE, "decode")])
def test_counts_match_flop_counter(section, which):
    _, weights = _ae(section, 13)
    dd = section["ddconfig"]
    x = (torch.rand(1, 32, 32, dd["in_channels"]) if which == "encode"
         else torch.randn(1, 8, 8, section["embed_dim"]))  # f = 4: two downsamples
    fn = vae.encode if which == "encode" else vae.decode
    with FlopCounterMode(display=False) as counter:
        fn(weights, section, x)
    flops = ae_counts.encode_flops(section, 1, 32) if which == "encode" else ae_counts.decode_flops(section, 1, 32)
    assert counter.get_total_flops() == flops
    sites = ae_counts.attention_sites(section, 32, which)
    assert len(sites) == 1 + dd["num_res_blocks"] + (which == "decode")  # the placed level's blocks and the mid one


def test_published_counts():
    """The published pair at 512^2: ~2.51 TFLOP a decode and ~0.63 an encode,
    compute-bound at the fp32 peak; one plain mid site each (4,096 tokens of
    width 512 and 384)."""
    image = _section(128, (1, 2, 4, 4), 2, (16, 8), 1, 1, 512)
    cond = _section(96, (1, 2, 4, 4), 2, (16, 8), 2, 2, 512)
    assert 2.5e12 < ae_counts.decode_flops(image, 1, 512) < 2.52e12
    assert 0.63e12 < ae_counts.encode_flops(cond, 1, 512) < 0.64e12
    assert ae_counts.decode_bytes(image, 1, 512) / 3.35e12 < 0.1 * ae_counts.decode_flops(image, 1, 512) / 67e12
    assert ae_counts.attention_sites(image, 512, "decode") == [(4096, 512)]
    assert ae_counts.attention_sites(cond, 512, "encode") == [(4096, 384)]
    assert ae_counts.plain_attention_sites(image, 512, "decode") == ae_counts.plain_attention_sites(cond, 512,
                                                                                                     "encode") == 1


def _latent(dtype=torch.float32):
    first, w_first = _ae(IMAGE, 21)
    cond, w_cond = _ae(COND, 22)
    ldm = LatentSliceLDM.create(first_stage=first, cond_stage=cond, image_channels=4, cond_channels=4,
                                timesteps=UNET["timesteps"], model_channels=UNET["model_channels"],
                                channel_mult=tuple(UNET["channel_mult"]),
                                attention_resolutions=tuple(UNET["attention_resolutions"]),
                                num_res_blocks=UNET["num_res_blocks"], num_head_channels=UNET["num_head_channels"],
                                dtype=dtype, device="cpu")
    w_unet = make_weights({n: p.shape for n, p in ldm.unet.named_parameters()}, 23, "cpu")
    ldm.unet.load_state_dict(w_unet)
    return ldm, {"unet": w_unet, "first_stage": w_first, "cond_stage": w_cond}


def _mask(batch=2, depth=3):
    labels = torch.arange(batch * depth * 32 * 32).reshape(batch, depth, 32, 32, 1) % 5
    return labels.float() / 4


STEPS = 4


def _reference_slice(weights, seed, z, prev, mask_slice):
    """Slice z from the port's previous slice: the cond encode, the DDIM chain
    from the replayed x_T, the decode, min-max."""
    replay = Replay(seed, "cpu")
    for _ in range(z + 1):
        x = replay.normal((prev.shape[0], 8, 8, 4))
    cond = vae.encode(weights["cond_stage"], COND, torch.cat([prev, mask_slice], dim=-1))
    ts, a, a_prev = rd.ddim_schedule(rd.ldm_alphas_cumprod(UNET["timesteps"], UNET["linear_start"],
                                                           UNET["linear_end"]), STEPS)
    for i in reversed(range(len(ts))):
        eps = unet_forward(weights["unet"], UNET, x, torch.full((x.shape[0],), float(ts[i])), cond)
        x = rd.ddim_update(x, eps, float(a[i]), float(a_prev[i]))
    return rd.minmax(vae.decode(weights["first_stage"], IMAGE, x))


def test_latent_slice_step_matches_reference():
    """Two slices of a volume (the first from zeros, the second from the
    port's first): encode, DDIM-4, decode and min-max against the plain
    composition, the port's UNet in fp32."""
    ldm, weights = _latent()
    mask = _mask()
    ddim = DDIMParams.create(ldm.diffusion, STEPS)
    stream = ldm.stream_volume(NoiseSource(5, "cpu"), mask, ddim)
    prev = torch.zeros(2, 32, 32, 1)
    with torch.no_grad():
        for z in range(2):
            got = next(stream)
            ref = _reference_slice(weights, 5, z, prev, mask[:, z])
            assert got.shape == ref.shape == (2, 32, 32, 1)
            assert float((got - ref).abs().max()) <= 1e-4  # [0, 1] units: fp32 sums in another order, stretched
            prev = got


def _stream(ldm, slices=2):
    ddim = DDIMParams.create(ldm.diffusion, STEPS)
    with torch.no_grad():
        stream = ldm.stream_volume(NoiseSource(7, "cpu"), _mask(), ddim)
        return torch.stack([next(stream) for _ in range(slices)])


def test_spans_open_in_order():
    """A latent slice step records ae.encode, the chain's sampler.step nodes
    (each with its UNet call inside), ae.decode, then slice.post."""
    ldm, _ = _latent(torch.bfloat16)
    spans.trace_spans(True)
    _stream(ldm, slices=1)
    top = [r.name for r in spans.records() if r.depth == 0]
    assert top == ["ae.encode"] + ["sampler.step"] * STEPS + ["ae.decode", "slice.post"]
    steps = [i for i, r in enumerate(spans.records()) if r.name == "sampler.step"]
    assert all(spans.records()[i + 1].name == "unet" for i in steps)


def test_counters_count_calls_and_plain_sites():
    """One cond encode and one decode a slice, and the plain attention
    launches of the chain's UNet calls and of the two AE calls' sites, as
    the benchmark's reader expects them from the shapes."""
    ldm, _ = _latent(torch.bfloat16)
    before = {"ae_encode": latent_ldm.ae_encode.launches, "ae_decode": latent_ldm.ae_decode.launches,
              "plain_attention": port_attention.plain_attention.launches}
    _stream(ldm, slices=2)
    counted = {"ae_encode": latent_ldm.ae_encode.launches - before["ae_encode"],
               "ae_decode": latent_ldm.ae_decode.launches - before["ae_decode"],
               "plain_attention": port_attention.plain_attention.launches - before["plain_attention"]}

    class Run:
        config = dict(UNET, first_stage=IMAGE, cond_stage=COND)
        workload = {"slice_size": 32, "ddim_steps": STEPS, "batch": 2}
        state = {"traced_units": 2}
        unet_shape = (2, (8, 8))

    assert counted == ae_readers.expected_counts(Run())
    assert counted["plain_attention"] == 2 * (STEPS * 4 + 2 + 4)  # the UNet's 4 sites at 16 tokens; the AEs' 2 and 4


def test_volumes_bit_equal_with_recorder_on_and_off():
    ldm, _ = _latent(torch.bfloat16)
    off = _stream(ldm)
    spans.trace_spans(True)
    on = _stream(ldm)
    assert spans.records()
    assert torch.equal(on, off)


@pytest.mark.parametrize("counted_ok", [True, False])
def test_ae_readers(counted_ok, monkeypatch):
    """`ae_card_ms` sums the AE spans' card time a unit; `ae_roofline` puts
    the calls' bound over it, and reads None where the counters disagree
    with the shapes."""
    ms = 1_000_000
    recs = [spans.SpanRecord("ae.encode", 0, 0, 1, 0, 50 * ms), spans.SpanRecord("sampler.step", 0, 1, 2, 50 * ms,
                                                                                 60 * ms),
            spans.SpanRecord("ae.decode", 0, 2, 3, 60 * ms, 260 * ms)]
    monkeypatch.setattr(spans, "records", lambda: recs)

    class Run:
        profile = object()
        config = {"first_stage": _section(128, (1, 2, 4, 4), 2, (16, 8), 1, 1, 512),
                  "cond_stage": _section(96, (1, 2, 4, 4), 2, (16, 8), 2, 2, 512),
                  "model_channels": 160, "channel_mult": [1, 2, 4, 4, 5], "num_res_blocks": 2,
                  "attention_resolutions": [8, 4, 2], "num_head_channels": 32}
        workload = {"slice_size": 512, "ddim_steps": 50, "batch": 4}
        unet_shape = (4, (64, 64))
        state = {"traced_units": 1}

    run = Run()
    expected = ae_readers.expected_counts(run)
    assert expected == {"ae_encode": 1, "ae_decode": 1, "plain_attention": 50 * 11 + 2}
    run.state["traced_counts"] = dict(expected, plain_attention=expected["plain_attention"] + (0 if counted_ok else 1))
    assert ae_readers.ae_card_ms(run) == pytest.approx(250.0)
    share = ae_readers.ae_roofline(run)
    if not counted_ok:
        assert share is None
        return
    bound = (4 * ae_counts.encode_flops(run.config["cond_stage"], 1, 512)
             + 4 * ae_counts.decode_flops(run.config["first_stage"], 1, 512)) / 67e12
    assert share == pytest.approx(100 * bound / 0.25)
    assert math.isfinite(share) and 0 < share < 100
