"""PyTorch port: UNet inference calls replayed as CUDA graphs (`nn/graphed.py`).

On the CPU a stand-in for the card's graph runs the bookkeeping: it "captures"
by running the call once (as a capture runs the wrappers' Python) and
"replays" by running it again with the launch counters held still and the
span recorder paused (a replay runs no Python), writing into the captured
output.  The kernel wrappers' plain CPU versions are wrapped to count a
launch per call, as the card's kernels do.  So the eligibility rule, the
key, the LRU bound, the counters' deltas, the clone of the output and the
spans are checked here; the `cuda` cases run the real graphs against eager
at tiny widths on a card (`chip_smoke.py graphs` runs them at the cells'
widths)."""

import copy
import importlib
import pkgutil

import pytest
import torch

import jointimagegeneration_torch.ops as ops_package

from jointimagegeneration_torch.core import logging as spans
from jointimagegeneration_torch.nn import blocks, graphed
from jointimagegeneration_torch.nn.graphed import CudaGraph, GraphCache, eager_unet, unet_graph
from jointimagegeneration_torch.nn.unet import UNet
from jointimagegeneration_torch.diffusion.ddim import DDIMParams
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.models.mask_sampler import MaskSampler
from jointimagegeneration_torch.models.slice_ldm import SliceLDM
from jointimagegeneration_torch.ops import attention, flash_attention, group_norm, launch_counters
from jointimagegeneration_torch.parallel.mesh import Mesh

# 32x32 slices: attention at ds 1 is a flash site (1,024 tokens), at ds 2 a plain one (256)
UNET_2D = dict(in_channels=3, model_channels=8, out_channels=1, num_res_blocks=1, attention_resolutions=(1, 2),
               channel_mult=(1, 2), dims=2, num_head_channels=4)


class StandInGraph:
    """`CudaGraph`'s interface on the CPU (see the module's docstring)."""

    device_type = "cpu"
    captured = []
    stream_id = 0

    def __init__(self, device, pool):
        self.fn = self.inputs = self.output = None
        self.pool = pool

    @staticmethod
    def new_pool(device):
        return object()

    def capture(self, fn, inputs):
        StandInGraph.captured.append(spans.span("probe", True))  # what a span gives inside a capture
        self.fn, self.inputs = fn, inputs
        self.output = fn(*inputs)
        return self.output

    def replay(self):
        held = launch_counters.counts()
        with spans.spans_paused():
            out = self.fn(*self.inputs)
        for (fn, name), value in held.items():
            setattr(fn, name, value)
        self.output.copy_(out)

    @staticmethod
    def stream(device):
        return StandInGraph.stream_id

    @staticmethod
    def capturing():
        return False


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def counted(monkeypatch):
    """The plain CPU versions count the launches their kernels would."""
    gn_plain, fa_plain = blocks.group_norm_plain, flash_attention.flash_attention_plain

    def gn(*a, **kw):
        group_norm.group_norm_act.launches += 2
        return gn_plain(*a, **kw)

    def fa(*a, **kw):
        flash_attention.flash_forward.launches += 1
        return fa_plain(*a, **kw)

    monkeypatch.setattr(blocks, "group_norm_plain", gn)
    monkeypatch.setattr(flash_attention, "flash_attention_plain", fa)
    StandInGraph.captured.clear()
    StandInGraph.stream_id = 0
    spans.trace_spans(False)
    spans.reset_spans()
    yield
    spans.trace_spans(False)
    spans.reset_spans()


def _unet(**kw) -> UNet:
    net = UNet(device="cpu", seed=3, **dict(UNET_2D, **kw))
    with torch.no_grad():  # un-zero the zero-init kernels, so every block reaches the output
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    net._graphs = GraphCache(graph=StandInGraph)
    return net


def _inputs(b: int = 2, hw: int = 32, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, hw, hw, 1), generator=g), torch.full((b,), 7.0),
            torch.randn((b, hw, hw, 2), generator=g))


def _counts() -> dict:
    return {"flash_forward": flash_attention.flash_forward.launches,
            "plain_attention": attention.plain_attention.launches,
            "group_norm_act": group_norm.group_norm_act.launches,
            "captures": unet_graph.captures, "replays": unet_graph.replays}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


@pytest.mark.parametrize("case", ["grad", "cpu", "mesh", "sharded", "forced", "hooked"])
def test_ineligible_calls_run_eager(case):
    """Autograd on, a CPU tensor under the card's graph, a mesh over other
    devices, a 'model' axis, a forced eager block and a hooked submodule:
    three calls, no capture, outputs equal to eager."""
    net = _unet()
    x, t, c = _inputs()
    with eager_unet(), torch.no_grad():
        want = net(x, t, c)
    ctx = torch.no_grad()
    if case == "grad":
        ctx = torch.enable_grad()
    elif case == "cpu":
        net._graphs = GraphCache(graph=CudaGraph)
    elif case == "mesh":
        net.set_mesh(Mesh([["cpu"], ["cpu"]]))
    elif case == "sharded":
        net.set_mesh(Mesh([["cpu", "cpu"]]), "model")
    elif case == "forced":
        ctx = eager_unet()
    else:
        net.mid_res1.register_forward_hook(lambda *_: None)
    before = _counts()
    with ctx, torch.no_grad() if case != "grad" else torch.enable_grad():
        outs = [net(x, t, c) for _ in range(3)]
    d = _delta(before)
    assert (d["captures"], d["replays"], len(net._graphs)) == (0, 0, 0)
    for out in outs:
        torch.testing.assert_close(out.detach(), want, rtol=0, atol=0 if case not in ("mesh", "sharded") else 1e-5)


def test_first_call_warms_second_captures_then_replays_bit_for_bit():
    """Call 1 runs eager, call 2 captures and replays once, calls 3-5 replay;
    each output equals the eager call's bit for bit; a copy of the module
    starts with no graphs."""
    net = _unet()
    calls = [_inputs(seed=s) for s in range(5)]
    with eager_unet(), torch.no_grad():
        want = [net(*a) for a in calls]
    before = _counts()
    with torch.no_grad():
        got = [net(*a) for a in calls]
    d = _delta(before)
    assert (d["captures"], d["replays"], len(net._graphs)) == (1, 3, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(copy.deepcopy(net)._graphs) == 0


@pytest.mark.parametrize("change", ["shape", "batch", "none_pattern", "dtype", "strides", "parameter", "tf32",
                                    "inplace"])
def test_key_captures_anew_on_what_changes_the_call(change):
    """A new shape, batch, None/tensor pattern, dtype or layout of an input,
    a replaced parameter and a changed TF32 flag each take a new key (a
    warm-up, then a capture); an in-place weight update keeps the key and
    the replay reads the new weights."""
    net = _unet()
    x, t, c = _inputs()
    with torch.no_grad():
        for _ in range(2):
            net(x, t, c)
    assert len(net._graphs) == 1
    args, restore = (x, t, c), None
    if change == "shape":
        args = _inputs(hw=16)
    elif change == "batch":
        args = _inputs(b=3)
    elif change == "none_pattern":
        args = (torch.cat([x, c], dim=-1), t, None)
    elif change == "dtype":
        args = (x.double(), t, c)
    elif change == "strides":
        args = (x, t, c.transpose(1, 2).contiguous().transpose(1, 2))
    elif change == "parameter":
        net.out_conv.weight = torch.nn.Parameter(net.out_conv.weight.detach().clone())
    elif change == "tf32":
        restore = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = not restore
    else:
        with torch.no_grad():
            net.out_conv.weight.mul_(1.5)
    try:
        before = _counts()
        with torch.no_grad():
            outs = [net(*args) for _ in range(3)]
        with eager_unet(), torch.no_grad():
            want = net(*args)
        d = _delta(before)
    finally:
        if restore is not None:
            torch.backends.cudnn.allow_tf32 = restore
    if change == "inplace":
        assert (d["captures"], d["replays"], len(net._graphs)) == (0, 3, 1)
    else:
        assert (d["captures"], d["replays"], len(net._graphs)) == (1, 1, 2)
    for out in outs:
        assert torch.equal(out, want)


def test_lru_eviction_at_the_bound(monkeypatch):
    """With room for two graphs, a third key's capture drops the least
    recently used; that key then warms up and captures again."""
    monkeypatch.setattr(graphed, "SIZE", 2)
    net = _unet()
    shapes = [_inputs(hw=hw) for hw in (8, 16, 32)]
    with torch.no_grad():
        for a in shapes[:2]:
            net(*a)
            net(*a)
        net(*shapes[0])  # key 0 most recently used: key 1 goes next
        net(*shapes[2])
        net(*shapes[2])
        assert len(net._graphs) == 2
        kept = {k[0][0][0][1] for k in net._graphs.graphs}
        assert kept == {8, 32}
        before = _counts()
        for _ in range(3):
            net(*shapes[1])
    assert _delta(before)["captures"] == 1 and _delta(before)["replays"] == 1


def test_counters_advance_by_the_captured_delta():
    """flash_forward, plain_attention and group_norm_act count, over a
    warm-up, a capture and replays, what the same eager calls count; the
    graph counters count one capture and the replays."""
    net = _unet()
    calls = [_inputs(seed=s) for s in range(5)]
    before = _counts()
    with eager_unet(), torch.no_grad():
        for a in calls:
            net(*a)
    eager = _delta(before)
    before = _counts()
    with torch.no_grad():
        for a in calls:
            net(*a)
    replayed = _delta(before)
    assert eager["flash_forward"] == 5 * 3 and eager["plain_attention"] == 5 * 4  # 3 flash, 4 plain sites a call
    assert eager["group_norm_act"] > 0
    for name in ("flash_forward", "plain_attention", "group_norm_act"):
        assert replayed[name] == eager[name], name
    assert (replayed["captures"], replayed["replays"]) == (1, 3)
    entry = next(iter(net._graphs.graphs.values()))
    delta = {fn.__name__: n for (fn, _), n in entry.delta}
    assert delta == {"flash_forward": 3, "plain_attention": 4, "group_norm_act": eager["group_norm_act"] // 5}


def test_guided_step_first_output_survives_the_second_call():
    """Classifier-free guidance calls one key twice a step: the first call's
    output is a clone, not the graph's buffer."""
    net = _unet()
    x, t, c = _inputs()
    null = torch.zeros_like(c)
    with torch.no_grad():
        net(x, t, c)
        net(x, t, c)
        out = net(x, t, c)
        kept = out.clone()
        out_u = net(x, t, null)
    assert torch.equal(out, kept)
    assert not torch.equal(out, out_u)
    assert out.data_ptr() != net._graphs.graphs[next(iter(net._graphs.graphs))].output.data_ptr()


def test_no_span_is_recorded_during_capture():
    """With the recorder on, a capture records `unet.capture` and no block
    span (a span opened inside it is the null one); the eager warm-up
    records every block, a replay only `unet`."""
    net = _unet()
    spans.trace_spans(True)
    x, t, c = _inputs()
    names = []
    with torch.no_grad():
        for _ in range(3):
            spans.reset_spans()
            net(x, t, c)
            names.append([r.name for r in spans.records()])
    assert StandInGraph.captured == [spans._OFF]
    warm, capture, replay = names
    assert "unet.head" in warm and "unet.mid_attn" in warm and "unet.tail" in warm
    assert sorted(capture) == ["unet", "unet.capture"]
    assert replay == ["unet"]


def test_feature_cond_sites_are_inputs():
    """`feature_cond` maps are copied into the graph's inputs at each
    replay: new maps give the eager output; a map at another shape is a new
    key."""
    net = UNet(device="cpu", seed=1, feature_cond_channels={0: 3}, **dict(UNET_2D, attention_resolutions=()))
    net._graphs = GraphCache(graph=StandInGraph)
    x, t, c = _inputs(hw=16)
    maps = [torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(s)) for s in range(4)]
    with eager_unet(), torch.no_grad():
        want = [net(x, t, c, feature_cond={0: m}) for m in maps]
    with torch.no_grad():
        got = [net(x, t, c, feature_cond={0: m}) for m in maps]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(net._graphs) == 1


def test_graphs_of_one_stream_share_one_pool():
    """The graphs of one cache on one stream capture into one pool; a call
    on another stream takes a pool of its own."""
    net = _unet()
    with torch.no_grad():
        for hw in (8, 16, 32):
            for _ in range(2):
                net(*_inputs(hw=hw))
        StandInGraph.stream_id = 1
        for _ in range(2):
            net(*_inputs(hw=8))
    pools = [e.graph.pool for e in net._graphs.graphs.values()]
    assert len(pools) == 4 and len(net._graphs.pools) == 2
    assert pools[0] is pools[1] is pools[2] and pools[3] is not pools[0]


OPS_MODULES = sorted(m.name for m in pkgutil.walk_packages(ops_package.__path__, ops_package.__name__ + "."))


@pytest.mark.parametrize("module", OPS_MODULES)
def test_every_launch_counter_is_registered(module):
    """A function of `ops` with an integer `*launches` attribute is in
    `launch_counters.COUNTED`, so a capture moves its counts onto the
    replays."""
    mod = importlib.import_module(module)
    for name, fn in vars(mod).items():
        counters = [k for k, v in getattr(fn, "__dict__", {}).items() if k.endswith("launches") and isinstance(v, int)]
        if callable(fn) and counters:
            assert fn in launch_counters.COUNTED, f"{module}.{name}: {counters}"


def _route(ldm, route: str, b: int):
    if route == "mask":
        return ldm.sample_labels(NoiseSource(b, "cpu"), (b, 4, 8, 8), cond=torch.zeros((b, 4, 8, 8, 1)), num_steps=4)
    ddim = DDIMParams.create(ldm.diffusion, 4, "uniform", 0.0)
    cond = torch.randn((b, 32, 32, 2), generator=torch.Generator().manual_seed(b))
    noise = NoiseSource(b, "cpu")
    if route == "plms":
        return ldm.sample_slice_plms(noise, cond, ddim)
    if route == "dpm":
        return ldm.sample_slice_dpm(noise, cond, ddim)
    kw = {"guided": {"guidance_scale": 2.0}, "tiled": {"tile": ((16, 16), (8, 8))}}.get(route, {})
    return ldm.sample_slice(noise, cond, ddim, **kw)


@pytest.mark.parametrize("route", ["ddim", "plms", "dpm", "guided", "tiled", "mask"])
def test_sampler_routes_make_one_key_a_batch_size(route):
    """The samplers' routes (the CLI's and the server's: a request runs the
    mask chain and then one slice chain a slice, at its batch) call the UNet
    with one key a batch size: guidance's unconditional call and every
    tiled window, edge windows included, share it; the outputs equal
    eager's."""
    unet = dict(model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,), num_res_blocks=1,
                num_head_channels=4, device="cpu")
    ldm = MaskSampler.create(num_classes=4, time_steps=20, **unet) if route == "mask" else \
        SliceLDM.create(timesteps=100, **unet)
    ldm.unet._graphs = GraphCache(graph=StandInGraph)
    cache = ldm.unet._graphs
    for b in (2, 1, 2):
        with eager_unet():
            want = _route(ldm, route, b)
        assert torch.equal(_route(ldm, route, b), want)
    assert len(cache.graphs) + len(cache.seen) == 2
    assert len(cache.graphs) == 2


# -- on a card --------------------------------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py graphs runs the same checks at the cells' widths")
    return torch.device("cuda", torch.cuda.current_device())


CARD_UNETS = {
    "pixel_2d": (dict(UNET_2D, model_channels=32, num_head_channels=32, dtype=torch.bfloat16), (2, 32, 32, 1), 2,
                 None),
    "latent_2d": (dict(UNET_2D, in_channels=8, out_channels=4, model_channels=32, num_head_channels=32,
                       attention_resolutions=(1, 2, 4), channel_mult=(1, 2, 2), dtype=torch.bfloat16),
                  (4, 32, 32, 4), 4, None),
    "mask_3d_context": (dict(in_channels=5, model_channels=16, out_channels=4, num_res_blocks=1,
                             attention_resolutions=(1,), channel_mult=(1, 2), dims=3, num_head_channels=8,
                             softmax_output=True, context_dim=32, dtype=torch.bfloat16),
                        (1, 8, 8, 8, 4), 1, (1, 512, 32)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_UNETS))
def test_graph_equals_eager_on_cuda(name):
    """The card's graphs against eager, bit for bit, over 5 calls; the
    launch counters equal."""
    device = _card()
    kw, shape, cond_ch, ctx_shape = CARD_UNETS[name]
    net = UNet(device=device, seed=5, **kw)
    g = torch.Generator(device=device).manual_seed(0)
    calls = []
    for s in range(5):
        x = torch.randn(shape, generator=g, device=device)
        cond = torch.randn((*shape[:-1], cond_ch), generator=g, device=device)
        ctx = None if ctx_shape is None else torch.randn(ctx_shape, generator=g, device=device)
        calls.append((x, torch.full((shape[0],), 10.0 * s + 1, device=device), cond, ctx))
    before = _counts()
    with eager_unet(), torch.inference_mode():
        want = [net(x, t, c, context=ctx) for x, t, c, ctx in calls]
    eager = _delta(before)
    before = _counts()
    with torch.inference_mode():
        got = [net(x, t, c, context=ctx) for x, t, c, ctx in calls]
    replayed = _delta(before)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for k in ("flash_forward", "plain_attention", "group_norm_act"):
        assert replayed[k] == eager[k], k
    assert (replayed["captures"], replayed["replays"]) == (1, 3)


@pytest.mark.cuda
def test_group_norm_buffer_outlives_the_capture_on_cuda():
    """A larger call grows the GroupNorm workspace after a capture; the graph
    keeps the buffer it captured, and its replays still equal eager."""
    device = _card()
    net = UNet(device=device, seed=5, **dict(UNET_2D, model_channels=32, num_head_channels=32,
                                             dtype=torch.bfloat16))
    x, t = torch.randn((1, 16, 16, 1), device=device), torch.full((1,), 5.0, device=device)
    c = torch.randn((1, 16, 16, 2), device=device)
    with torch.inference_mode():
        net(x, t, c)
        net(x, t, c)
        captured = {b.data_ptr() for b in group_norm.live_buffers()}
        big = (torch.randn((8, 64, 64, 1), device=device), torch.full((8,), 5.0, device=device),
               torch.randn((8, 64, 64, 2), device=device))
        net(*big)
        assert {b.data_ptr() for b in group_norm.live_buffers()} != captured
        torch.empty(64 << 20, dtype=torch.uint8, device=device).fill_(255)  # reuse freed memory, if any was
        got = net(x, t, c)
        with eager_unet():
            want = net(x, t, c)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_rotating_keys_share_one_pool_on_cuda():
    """Three batch sizes captured into one pool and replayed in another
    order than their captures, each replay bit for bit against eager."""
    device = _card()
    net = UNet(device=device, seed=5, **dict(UNET_2D, model_channels=32, num_head_channels=32,
                                             dtype=torch.bfloat16))
    g = torch.Generator(device=device).manual_seed(1)

    def call(b):
        return (torch.randn((b, 32, 32, 1), generator=g, device=device), torch.full((b,), 7.0, device=device),
                torch.randn((b, 32, 32, 2), generator=g, device=device))

    with torch.inference_mode():
        for b in (1, 2, 3):
            for _ in range(2):
                net(*call(b))
        assert len(net._graphs) == 3 and len(net._graphs.pools) == 1
        for _ in range(3):
            for b in (3, 1, 2):
                args = call(b)
                got = net(*args)
                with eager_unet():
                    want = net(*args)
                assert torch.equal(got, want), b
