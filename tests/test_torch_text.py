"""PyTorch port: the text encoders (`nn/text.py`) and the condition-encoder
registry (`models/cond_encoders.py`) against the JAX package's, on the CPU.

Tolerances: the refiner in fp32 within 1e-5 of its output's max |.| (at 512
tokens the port's flash plain version against the JAX CPU path's XLA
attention); the frozen BERT features equal (both run the same torch model);
the registry's arithmetic exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import sample as tcli
from jointimagegeneration_torch.models import cond_encoders as tce
from jointimagegeneration_torch.nn import text as ttext
from jointimagegeneration_torch.utils.jax_weights import flatten_tree, unet_state_dict_from_jax
from jointimagegeneration_tpu.models import cond_encoders as jce
from jointimagegeneration_tpu.nn import text as jtext

from test_torch_weights import assert_close_scaled, init_flax, jax_apply, load_port, to_numpy, to_torch

TINY = dict(embed_dim=16, n_heads=2, depth=2, d_head=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tokens", [4, 512])
def test_refiner_matches_jax(tokens):
    """Two self-attention blocks (attn1 and attn2 both without a context) and
    the input residual; dropout off, as at sampling."""
    feats = np.random.RandomState(0).randn(2, tokens, 16).astype(np.float32)
    jmod = jtext.TextFeatureRefiner(dropout=0.2, **TINY)
    p = init_flax(jmod, jnp.asarray(feats))
    want = np.asarray(jax_apply(jmod, p, jnp.asarray(feats)))
    port = load_port(ttext.TextFeatureRefiner(dropout=0.2, device="cpu", **TINY), p)
    with torch.no_grad():
        got = to_numpy(port(to_torch(feats)))
    assert_close_scaled(got, want, 1e-5)
    assert np.abs(got - feats).max() > 1e-2  # the blocks change the features


def test_refiner_tree_names_map_by_name():
    """The flax tree of a tiny refiner, printed, maps onto the port's
    parameters name for name: FeedForward's auto-names `ff/GEGLU_0/Dense_0`
    (kernel (D, 8D)) and `ff/Dense_0` (kernel (4D, D)), no bias on
    to_q / to_k / to_v, LayerNorm `scale` -> `weight`."""
    shapes = jax.eval_shape(jtext.TextFeatureRefiner(**TINY).init, jax.random.key(0), jnp.zeros((1, 4, 16)))
    flat = flatten_tree(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    for path in sorted(flat):
        print("/".join(path), flat[path].shape)
    assert flat[("params", "block_0", "ff", "GEGLU_0", "Dense_0", "kernel")].shape == (16, 128)
    assert flat[("params", "block_0", "ff", "Dense_0", "kernel")].shape == (64, 16)
    assert ("params", "block_1", "attn2", "to_q", "bias") not in flat
    assert flat[("params", "block_1", "attn2", "to_out", "bias")].shape == (16,)
    port = ttext.TextFeatureRefiner(device="cpu", **TINY)
    bridged = unet_state_dict_from_jax(flat)
    own = port.state_dict()
    assert sorted(bridged) == sorted(own)
    assert all(bridged[k].shape == own[k].shape for k in own)
    assert own["block_0.norm1.weight"].eq(1).all() and own["block_0.attn1.to_out.bias"].eq(0).all()


def test_refiner_fresh_init_is_seeded():
    a, b = (ttext.TextFeatureRefiner(device="cpu", seed=3, **TINY) for _ in range(2))
    c = ttext.TextFeatureRefiner(device="cpu", seed=4, **TINY)
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(p, q)
        if n.endswith("weight") and p.ndim == 2:
            assert not torch.equal(p, r)
            std = p.std().item() * np.sqrt(p.shape[1])  # lecun normal: variance 1 / fan_in
            assert 0.6 < std < 1.2, (n, std)
    if not torch.cuda.is_available():  # the port's rule: CUDA unless the caller names the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            ttext.TextFeatureRefiner(**TINY)


def test_identity_encoder():
    x = torch.randn(2, 3)
    enc = ttext.IdentityEncoder()
    assert enc(x) is x and enc.encode(x) is x


def _tiny_bert(tmp_path):
    transformers = pytest.importorskip("transformers")
    words = ["the", "liver", "is", "enlarged", "kidney", "normal", "no", "mass", "spleen", "lesion"]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    transformers.BertTokenizer(str(vocab)).save_pretrained(str(tmp_path / "bert"))
    torch.manual_seed(0)
    cfg = transformers.BertConfig(vocab_size=15, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                                  intermediate_size=32, max_position_embeddings=32)
    transformers.BertModel(cfg).save_pretrained(str(tmp_path / "bert"))
    return str(tmp_path / "bert")


@pytest.mark.parametrize("max_length", [8, 512])
def test_frozen_bert_matches_jax(tmp_path, max_length):
    """A tiny BERT with a toy vocab saved under tmp_path: the long report
    chunked at max_length 8 (4 chunks) or whole, the short text zero-padded
    to the longest; the port's features equal the JAX package's."""
    path = _tiny_bert(tmp_path)
    texts = ["the liver is enlarged no mass " * 4, "normal spleen"]
    want = jtext.FrozenBERTEmbedder(path, max_length=max_length)(texts)
    got = ttext.FrozenBERTEmbedder(path, max_length=max_length, device="cpu")(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] == 2 and got.shape[1] > 8 and got.shape[2] == 16
    np.testing.assert_array_equal(got, want)
    assert (got[1, 4:] == 0).all() and np.abs(got[1, :4]).max() > 0
    single = ttext.FrozenBERTEmbedder(path, max_length=max_length, device="cpu")("normal spleen")
    np.testing.assert_array_equal(single[0], got[1, :single.shape[1]])


def test_cli_text_from_a_local_bert(tmp_path):
    """`text: {bert_path, prompt}` encodes the prompt with the frozen BERT;
    the labels equal those from a features file holding the same features."""
    path = _tiny_bert(tmp_path)
    prompt = "the liver is enlarged no mass"
    feats = ttext.FrozenBERTEmbedder(path, device="cpu")(prompt)[0]
    np.savez(tmp_path / "feats.npz", feats)
    s1 = {"num_classes": 4, "time_steps": 20, "bf16": False,
          "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                          "num_head_channels": 4, "num_res_blocks": 1},
          "feature_cond_encoder": {"type": "selfattn", "embed_dim": 16, "n_heads": 2, "d_head": 8, "model_depth": 1},
          "dataset": {"volume_shape": [4, 8, 8], "num_cases": 1}}
    cfg = {"stage": "mask", "device": "cpu", "seed": 1, "mask_steps": 2, "fresh_init_noise": 0.05, "stage1": s1,
           "output_path": str(tmp_path / "a"), "text": {"bert_path": path, "prompt": prompt}}
    got = tcli.run(cfg)["labels"]
    ctx = tcli.load_text_context(cfg["text"], "cpu")
    assert ctx.shape == (1, feats.shape[0], 16) and ctx.dtype == torch.float32
    want = tcli.run({**cfg, "output_path": str(tmp_path / "b"), "text": {"features_npz": str(tmp_path / "feats.npz")}})
    np.testing.assert_array_equal(got, want["labels"])
    assert tcli.load_text_context(None, "cpu") is None and tcli.load_text_context({}, "cpu") is None


def test_build_feature_cond_encoder():
    assert tce.build_feature_cond_encoder(None) == (None, False)
    assert tce.build_feature_cond_encoder({"type": "none"}) == (None, False)
    enc, trainable = tce.build_feature_cond_encoder({"type": "selfattn", "embed_dim": 16, "d_head": 8},
                                                    device="cpu")
    jenc, _, jtrain = jce.build_feature_cond_encoder({"type": "selfattn", "embed_dim": 16, "d_head": 8})
    assert trainable and jtrain and isinstance(enc, ttext.TextFeatureRefiner)
    assert enc.depth == jenc.depth == 4 and enc.block_0.attn1.heads == jenc.n_heads == 8
    assert enc.block_0.ff.rate == jenc.dropout == 0.2 and enc.embed_dim == 16
    _, frozen = tce.build_feature_cond_encoder({"type": "selfattn", "train": False, "embed_dim": 16,
                                                "model_depth": 1}, device="cpu")
    assert not frozen
    with pytest.raises(NotImplementedError, match="item 7"):
        tce.build_feature_cond_encoder({"type": "dino"})
    with pytest.raises(ValueError, match="unknown"):
        tce.build_feature_cond_encoder({"type": "clip"})


@pytest.mark.parametrize("mult,nrb", [((1, 2, 2, 4, 5), 2), ((1, 2), 1), ((1, 2, 4), 3)])
def test_inject_site_downsample_matches_jax(mult, nrb):
    n_sites = len(mult) * nrb + len(mult) - 1
    got = [tce.inject_site_downsample(mult, nrb, i) for i in range(n_sites + 1)]
    assert got == [jce.inject_site_downsample(mult, nrb, i) for i in range(n_sites + 1)]
    for mod in (tce, jce):
        with pytest.raises(ValueError, match="beyond"):
            mod.inject_site_downsample(mult, nrb, n_sites + 1)
