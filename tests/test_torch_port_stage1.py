"""The port's stage-1 modules against the JAX package, on the CPU in fp32.

Inputs come from numpy seeds and go to both sides; weights are drawn by the
JAX modules' init and carried over with ``lam_slide_tpu_torch.convert``.
Every JAX attention runs with ``backend="pallas"``, so the masked calls go
through K1's bias row in interpret mode (as tests/test_flash_attention.py
runs it); the port's wrappers take their plain versions on CPU tensors.
Tolerance: fp32 on both sides, only the order of fp32 sums differs (2e-5,
as tests/test_torch_parity.py holds the JAX modules to the reference).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.composites import md17 as jmd17
from lam_slide_tpu.models import Encoder as JEncoder
from lam_slide_tpu.nn import blocks as jblocks
from lam_slide_tpu.nn import embeddings as jemb
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.composites import md17 as tmd17
from lam_slide_tpu_torch.models.decoder import Decoder
from lam_slide_tpu_torch.models.encoder import Encoder, Encoder2
from lam_slide_tpu_torch.nn import blocks as tblocks
from lam_slide_tpu_torch.nn import embeddings as temb
from lam_slide_tpu_torch.nn import initializers as inits

ATOL = RTOL = 2e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "encoder_decoder_golden.npz")


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mask(rng, b, n, all_masked_row=True):
    """[B, N] key-padding mask with ragged lengths; row 0 fully masked."""
    lengths = rng.integers(1, n + 1, size=b)
    mask = np.arange(n)[None, :] < lengths[:, None]
    if all_masked_row:
        mask[0] = False
    return mask


# --- embeddings ------------------------------------------------------------------------


def test_point_embed_matches_jax():
    rng = np.random.default_rng(0)
    x = _randn(rng, 2, 7, 3)
    jmod = jemb.PointEmbed(hidden_dim=126, embedding_dim=32)
    params = _np_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tmod = temb.PointEmbed(126, 32)
    tmod.load_state_dict({"mlp.weight": _t(params["mlp"]["kernel"].T),
                          "mlp.bias": _t(params["mlp"]["bias"])})
    _close(tmod(_t(x)), jmod.apply({"params": params}, jnp.asarray(x)))


def test_embed_max_norm_matches_jax():
    """Rows above and below max_norm: the long ones are clamped at lookup,
    the stored table is left as it was."""
    rng = np.random.default_rng(1)
    table = _randn(rng, 6, 8, scale=0.6)  # row norms around 1.7 and some below 1
    table[2] *= 0.1
    ids = rng.integers(0, 6, size=(3, 5))
    jmod = jemb.Embed(num_embeddings=6, embedding_dim=8, max_norm=1.0)
    want = jmod.apply({"params": {"embedding": jnp.asarray(table)}}, jnp.asarray(ids))
    tmod = temb.Embed(6, 8, max_norm=1.0)
    tmod.load_state_dict({"weight": _t(table)})
    _close(tmod(_t(ids)), want)
    np.testing.assert_array_equal(tmod.weight.detach().numpy(), table)
    norms = np.linalg.norm(table, axis=-1)
    assert (norms > 1).any() and (norms < 1).any()


def test_entity_embedding_is_a_frozen_orthonormal_table():
    tmod = temb.EntityEmbedding(50, 128, gen=torch.Generator().manual_seed(3))
    table = tmod.embedding.weight
    assert not list(tmod.parameters()) and "embedding.weight" in tmod.state_dict()
    torch.testing.assert_close(table @ table.t(), torch.eye(50), atol=1e-5, rtol=0)
    jmod = jemb.EntityEmbedding(n_entities=50, embedding_dim=128)
    ids = np.random.default_rng(2).integers(0, 50, size=(2, 9))
    want = jmod.apply({"constants": {"embedding": jnp.asarray(table.numpy())}}, jnp.asarray(ids))
    _close(tmod(_t(ids)), want, atol=0, rtol=0)


def test_trunc_normal_and_orthogonal_rows_draws():
    g = torch.Generator().manual_seed(0)
    w = inits.trunc_normal_(torch.empty(400, 300), g, std=0.02)
    assert w.abs().max().item() <= 2 * 0.02 / 0.87962566103423978 + 1e-7
    assert abs(w.std().item() - 0.02) < 5e-4
    tall = inits.orthogonal_rows_(torch.empty(20, 6), g)
    torch.testing.assert_close(tall.t() @ tall, torch.eye(6), atol=1e-5, rtol=0)


# --- attention and blocks -----------------------------------------------------------------


def _attention_sd(p):
    sd = {"to_out.weight": _t(p["to_out"]["kernel"].T), "to_out.bias": _t(p["to_out"]["bias"]),
          "norm.query_norm.scale": _t(p["norm"]["query_norm"]["scale"]),
          "norm.key_norm.scale": _t(p["norm"]["key_norm"]["scale"])}
    sd["to_q.weight"] = _t(p["to_q"]["kernel"].T)
    sd["to_kv.weight"] = _t(p["to_kv"]["kernel"].T)
    return sd


@pytest.mark.parametrize("nq,nk", [(6, 11), (130, 50)])
def test_masked_attention_matches_jax_kernel(nq, nk):
    """Cross-attention with a ragged key-padding mask and one fully masked
    row (uniform weights over its keys on both sides); the JAX side runs K1
    with the bias row in interpret mode."""
    rng = np.random.default_rng(3)
    x, ctx = _randn(rng, 3, nq, 16), _randn(rng, 3, nk, 24)
    mask = _mask(rng, 3, nk)
    jmod = jblocks.Attention(heads=2, dim_head=8, qk_norm=True, backend="pallas")
    params = _np_tree(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(ctx))["params"])
    params["norm"]["query_norm"]["scale"] = 1 + 0.2 * _randn(rng, 8)
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask))
    tmod = tblocks.Attention(16, 2, 8, context_dim=24, qk_norm=True)
    tmod.load_state_dict(_attention_sd(params))
    got = tmod(_t(x), _t(ctx), _t(mask))
    _close(got, want)
    # the fully masked row saw every key with equal weight
    unmasked = tmod(_t(x[:1]), _t(ctx[:1]), torch.ones(1, nk, dtype=torch.bool))
    assert not torch.allclose(got[:1], unmasked)


@pytest.mark.parametrize("cross", [True, False], ids=["cross", "self"])
def test_blocks_match_jax(cross):
    rng = np.random.default_rng(4)
    x, ctx = _randn(rng, 2, 9, 16), _randn(rng, 2, 13, 20)
    mask = _mask(rng, 2, 13 if cross else 9, all_masked_row=False)
    kw = dict(heads=2, dim_head=8, qk_norm=True, act=jblocks.gelu_exact, backend="pallas")
    if cross:
        jmod = jblocks.CrossAttentionBlock(**kw)
        args = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask))
        tmod = tblocks.CrossAttentionBlock(16, 20, 2, 8, qk_norm=True)
        targs = (_t(x), _t(ctx), _t(mask))
    else:
        jmod = jblocks.SelfAttentionBlock(**kw)
        args = (jnp.asarray(x), jnp.asarray(mask))
        tmod = tblocks.SelfAttentionBlock(16, 2, 8, qk_norm=True)
        targs = (_t(x), _t(mask))
    params = _np_tree(jmod.init(jax.random.PRNGKey(2), *args)["params"])
    sd = {}
    convert._block(sd, "b", params)
    tmod.load_state_dict({k[2:]: v for k, v in sd.items()})
    _close(tmod(*targs), jmod.apply({"params": params}, *args))


def test_feed_forward_and_gelus_match_jax():
    rng = np.random.default_rng(5)
    x = _randn(rng, 4, 12, scale=2.0)
    _close(tblocks.gelu_tanh(_t(x)), jblocks.gelu_tanh(jnp.asarray(x)))
    _close(tblocks.gelu_exact(_t(x)), jblocks.gelu_exact(jnp.asarray(x)))
    jmod = jblocks.FeedForward(dim=10, depth=2, out_dim=5)
    params = _np_tree(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    tmod = tblocks.FeedForward(12, 10, depth=2, out_dim=5)
    sd = {}
    for i, name in enumerate(["fc0", "fc1"]):
        sd[f"net.{i}.0.weight"] = _t(params[name]["kernel"].T)
        sd[f"net.{i}.0.bias"] = _t(params[name]["bias"])
    sd["net.2.weight"], sd["net.2.bias"] = _t(params["out"]["kernel"].T), _t(params["out"]["bias"])
    tmod.load_state_dict(sd)
    _close(tmod(_t(x)), jmod.apply({"params": params}, jnp.asarray(x)))


# --- encoder, decoder, backbone -------------------------------------------------------------

ENC = dict(dim_latent=16, num_latents=10, dim_head_cross=4, dim_head_latent=8, num_head_cross=2,
           num_head_latent=2, qk_norm=True)
JACT, TACT = dict(act=jblocks.gelu_exact), dict(act=tblocks.gelu_exact)


@pytest.mark.parametrize("interleaved", [False, True], ids=["Encoder", "Encoder2"])
def test_encoder_matches_jax(interleaved):
    rng = np.random.default_rng(6)
    x, emb = _randn(rng, 3, 11, 14), _randn(rng, 3, 11, 6)
    mask = _mask(rng, 3, 11)
    if interleaved:
        from lam_slide_tpu.models import Encoder2 as JEncoder2

        jmod = JEncoder2(num_block=2, backend="pallas", **ENC, **JACT)
        tmod = Encoder2(14, 6, num_block=2, **ENC, **TACT)
    else:
        jmod = JEncoder(num_block_cross=1, num_block_attn=2, backend="pallas", **ENC, **JACT)
        tmod = Encoder(14, 6, num_block_cross=1, num_block_attn=2, **ENC, **TACT)
    args = (jnp.asarray(x), jnp.asarray(emb), jnp.asarray(mask))
    params = _np_tree(jmod.init(jax.random.PRNGKey(4), *args)["params"])
    tmod.load_state_dict(convert.encoder_state_dict_from_jax(params, interleaved=interleaved))
    _close(tmod(_t(x), _t(emb), _t(mask)), jmod.apply({"params": params}, *args))


@pytest.mark.parametrize("variant", ["Decoder", "DecoderFE", "Decoder2"])
def test_decoder_matches_jax(variant):
    from lam_slide_tpu import models as jmodels
    from lam_slide_tpu_torch.models import decoder as tdecoder

    rng = np.random.default_rng(7)
    latent, emb = _randn(rng, 2, 10, 16), _randn(rng, 2, 7, 12)
    kw = dict(dim_head_cross=4, dim_head_latent=8, num_head_cross=2, num_head_latent=2,
              num_block_cross=1, num_block_attn=1, dropout_query=0.1, qk_norm=True)
    jmod = getattr(jmodels, variant)(outputs={"pos": 3, "atom": 5}, dim_query=12,
                                     backend="pallas", **kw, **JACT)
    params = _np_tree(jmod.init(jax.random.PRNGKey(5), jnp.asarray(latent),
                                jnp.asarray(emb))["params"])
    want = jmod.apply({"params": params}, jnp.asarray(latent), jnp.asarray(emb))
    tmod = getattr(tdecoder, variant)({"pos": 3, "atom": 5}, 16, 12, 12, **kw, **TACT).eval()
    tmod.load_state_dict(convert.decoder_state_dict_from_jax(params))
    got = tmod(_t(latent), _t(emb))
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name])


S1 = dict(n_atom_types=10, num_entities=12, dim_input=16, dim_latent=8, dim_entity=16,
          num_latents=10, dim_head_cross=4, dim_head_latent=4, num_head_cross=2,
          num_head_latent=2)


def _md17_frames(rng, b, n_pad=12):
    n_real = rng.integers(3, n_pad + 1, size=b)
    mask = np.arange(n_pad)[None, :] < n_real[:, None]
    return {"pos": _randn(rng, b, n_pad, 3) * mask[..., None],
            "atom": rng.integers(0, 10, size=(b, n_pad)) * mask,
            "entities": np.stack([rng.permutation(n_pad) for _ in range(b)]) * mask,
            "attention_mask": mask}


def _first_stages(seed=8):
    jcfg = jmd17.MD17FirstStageConfig(**S1)
    jmodel = jmd17.build_md17_first_stage(jcfg)
    jmodel = jmodel.clone(encoder=jmodel.encoder.clone(backend="pallas"),
                          decoder=jmodel.decoder.clone(backend="pallas"))
    frames = _md17_frames(np.random.default_rng(seed), 3)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(seed),
                                     {k: jnp.asarray(v) for k, v in frames.items()}))
    tmodel = tmd17.build_md17_first_stage(tmd17.MD17FirstStageConfig(**S1), device="cpu").eval()
    tmodel.load_state_dict(convert.first_stage_state_dict_from_jax(variables["params"],
                                                                   variables["constants"]))
    return jmodel, variables, tmodel, frames


def test_md17_input_embedder_matches_jax():
    jmodel, variables, tmodel, frames = _first_stages()
    want = jmd17.MD17InputEmbedder(n_atom_types=10, dim_input=16).apply(
        {"params": variables["params"]["input_embedder"]},
        {k: jnp.asarray(v) for k, v in frames.items()})
    _close(tmodel._embed_inputs({k: _t(v) for k, v in frames.items()}), want)


def test_first_stage_backbone_matches_jax():
    """encode (masked cross-attention through K1's bias in interpret mode)
    and decode of the MD17 backbone on converted weights."""
    jmodel, variables, tmodel, frames = _first_stages()
    jb = {k: jnp.asarray(v) for k, v in frames.items()}
    tb = {k: _t(v) for k, v in frames.items()}
    z_want = jmodel.apply(variables, jb, method=jmodel.encode)
    z = tmodel.encode(tb)
    _close(z, z_want)
    want = jmodel.apply(variables, z_want, jb["entities"], method=jmodel.decode)
    got = tmodel.decode(_t(np.asarray(z_want)), tb["entities"])
    for name in ("pos", "atom"):
        _close(got[name], want[name])


def test_encoder_decoder_golden_loads_with_load_state_dict():
    """The reference encoder/decoder state_dicts load as they are (keys and
    all) and reproduce the reference outputs."""
    g = np.load(GOLDEN)
    sd = {k: _t(g[k]) for k in g.files}
    common = dict(qk_norm=True, act=tblocks.gelu_tanh)
    enc = Encoder(10, 12, 8, 6, dim_head_cross=4, dim_head_latent=4, num_head_cross=2,
                  num_head_latent=2, **common)
    dec = Decoder({"pos": 3, "atom": 5}, 8, 12, 12, dim_head_cross=4, dim_head_latent=4,
                  num_head_cross=2, num_head_latent=2, num_block_cross=1, num_block_attn=1,
                  dropout_query=0.0, **common).eval()
    enc.entity_embedding = dec.entity_embedding = temb.EntityEmbedding(16, 12)
    enc.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("enc.")})
    dec.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("dec.")})
    torch.testing.assert_close(enc.entity_embedding.embedding.weight, sd["emb.embedding.weight"])
    entity_emb = enc.entity_embedding(_t(g["entities"]))
    latents = enc(_t(g["x"]), entity_emb, _t(g["mask"]))
    _close(latents, g["latents"])
    out = dec(_t(g["latents"]), entity_emb)
    _close(out["pos"], g["out_pos"])
    _close(out["atom"], g["out_atom"])
