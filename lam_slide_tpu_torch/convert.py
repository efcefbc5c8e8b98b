"""JAX param tree -> port state_dict (the reverse of ``train/torch_import.py``).

``latent_dit_state_dict_from_jax`` takes a flax ``LatentDiT`` param tree as
nested mappings of numpy arrays (unrolled ``block_i`` layout, or the
``blocks/layer`` scan layout with a leading depth axis, or the one
``block_shared`` layer of ``share_weights=True``, which becomes ``blocks.0``
as ``train/torch_import.py:346-347`` maps it) and returns the
port's ``LatentDiT`` state_dict; ``class_cond_dit_state_dict_from_jax`` does
the same for ``ClassCondDiT``, and ``first_stage_state_dict_from_jax`` for
the MD17, peptide, pedestrian and NBA ``FirstStageBackbone`` (its params
and its ``constants``, the frozen entity table). flax Dense kernels ``[in, out]``
become torch Linear weights ``[out, in]``.

The peptide key maps (stage 1's input embedder and the decoder's
``extender``; stage 2 is a plain ``LatentDiT``) are the reference's keys:
``tests/test_torch_port_peptide.py`` loads the trained reference checkpoint
``tests/golden/ref_trained_probe.ckpt`` straight into the port's smoke-width
stage 1 and holds it to that checkpoint's golden outputs, which pins these
names and layouts.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _pma(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    """flax ParallelMLPAttention -> torch ParallelMLPAttentionV2 keys
    (torch_import.py:296-305 in reverse)."""
    sd[prefix + ".linear1.weight"] = _t(np.asarray(p["linear1"]).T)
    sd[prefix + ".linear1.bias"] = _t(p["linear1_bias"])
    sd[prefix + ".norm.query_norm.scale"] = _t(p["q_norm_scale"])
    sd[prefix + ".norm.key_norm.scale"] = _t(p["k_norm_scale"])
    _dense(sd, prefix + ".linear2", p["linear2"])


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def latent_dit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax LatentDiT params -> port LatentDiT state_dict (fp32 tensors)."""
    if "params" in params and "x_in" not in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "x_in", params["x_in"])
    _dense(sd, "cond_to_emb", params["cond_to_emb"])
    sd["mask_to_emb.weight"] = _t(params["mask_to_emb"]["embedding"])
    for name in ("time_in", "vec_in"):
        if name in params:
            _dense(sd, f"{name}.in_layer", params[name]["in_layer"])
            _dense(sd, f"{name}.out_layer", params[name]["out_layer"])
    _dense(sd, "adaLN_modulation.1", params["adaLN_out"])
    _dense(sd, "linear", params["linear_out"])

    if "block_shared" in params:  # share_weights: one layer applied depth times
        blocks = [params["block_shared"]]
    elif "blocks" in params:  # scan layout: blocks/layer/... with a leading depth axis
        stacked = params["blocks"]["layer"]
        depth = np.asarray(stacked["modulation"]["lin"]["kernel"]).shape[0]
        blocks = [_unstack(stacked, i) for i in range(depth)]
    else:
        depth = sum(1 for k in params if k.startswith("block_"))
        blocks = [params[f"block_{i}"] for i in range(depth)]
    for i, blk in enumerate(blocks):
        _dense(sd, f"blocks.{i}.modulation.lin", blk["modulation"]["lin"])
        _pma(sd, f"blocks.{i}.spatial_block", blk["spatial_block"])
        _pma(sd, f"blocks.{i}.temporal_block", blk["temporal_block"])
    return sd


def class_cond_dit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ClassCondDiT params ({"dit", "vec_in_embedding"}) -> port
    ClassCondDiT state_dict (``backbone.*``, ``vec_in_embedding.weight``)."""
    if "params" in params and "dit" not in params:
        params = params["params"]
    sd = {f"backbone.{k}": v for k, v in latent_dit_state_dict_from_jax(params["dit"]).items()}
    sd["vec_in_embedding.weight"] = _t(params["vec_in_embedding"]["embedding"])
    return sd


def _ln(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["weight"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _block(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    """flax Cross/SelfAttentionBlock -> the reference PreNorm block keys
    (a block without ``norm_context`` is a self-attention block: its to_q
    and to_kv kernels become one ``to_qkv``)."""
    attn = p["attn"]
    if "norm_context" in p:
        _dense(sd, f"{prefix}.attn.fn.to_q", attn["to_q"])
        _dense(sd, f"{prefix}.attn.fn.to_kv", attn["to_kv"])
        _ln(sd, f"{prefix}.attn.norm_context", p["norm_context"])
    else:
        qkv = np.concatenate([np.asarray(attn["to_q"]["kernel"]),
                              np.asarray(attn["to_kv"]["kernel"])], axis=1)
        sd[f"{prefix}.attn.fn.to_qkv.weight"] = _t(qkv.T)
    _dense(sd, f"{prefix}.attn.fn.to_out", attn["to_out"])
    if "norm" in attn:
        sd[f"{prefix}.attn.fn.norm.query_norm.scale"] = _t(attn["norm"]["query_norm"]["scale"])
        sd[f"{prefix}.attn.fn.norm.key_norm.scale"] = _t(attn["norm"]["key_norm"]["scale"])
    _ln(sd, f"{prefix}.attn.norm", p["norm"])
    _dense(sd, f"{prefix}.ff.fn.net.0.0", p["ff"]["fc0"])
    _dense(sd, f"{prefix}.ff.fn.net.1", p["ff"]["out"])
    _ln(sd, f"{prefix}.ff.norm", p["norm_ff"])


def _count(p: Mapping, stem: str) -> int:
    return sum(1 for k in p if k.startswith(stem) and k[len(stem):].isdigit())


def encoder_state_dict_from_jax(p: Mapping, prefix: str = "",
                                interleaved: bool = False) -> Dict[str, torch.Tensor]:
    """flax Encoder params (or Encoder2's, with ``interleaved``: the flax
    scopes are the same, the reference keys (cross, self) pairs) -> port
    encoder keys (no entity table)."""
    sd: Dict[str, torch.Tensor] = {prefix + "latents": _t(p["latents"])}
    _dense(sd, prefix + "mlp.0", p["mlp_in"])
    _dense(sd, prefix + "mlp.2", p["mlp_out"])
    cross, self_ = (("cross_attn_blocks.{}.0", "cross_attn_blocks.{}.1") if interleaved
                    else ("cross_attn_blocks.{}", "blocks_attn.{}"))
    for i in range(_count(p, "cross_")):
        _block(sd, prefix + cross.format(i), p[f"cross_{i}"])
    for i in range(_count(p, "self_")):
        _block(sd, prefix + self_.format(i), p[f"self_{i}"])
    return sd


def decoder_state_dict_from_jax(p: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax Decoder / DecoderFE / Decoder2 / DecoderQuerySplitter params ->
    port decoder keys (no entity table). The QuerySplitter's ``extender``
    Dense ``[D, D * num_split]`` becomes the reference's Conv1d weight
    ``extender.1.weight [D * num_split, D, 1]`` (same d-major channels)."""
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, prefix + "query_mlp.1", p["query_mlp"])
    for i in range(_count(p, "self_")):
        _block(sd, f"{prefix}self_attn_blocks.{i}", p[f"self_{i}"])
    for i in range(_count(p, "cross_")):
        _block(sd, f"{prefix}cross_attn_blocks.{i}", p[f"cross_{i}"])
    _block(sd, prefix + "output_block", p["output_block"])
    for key in p:
        if key.startswith("head_") and key.endswith("_fc"):
            name = key[len("head_"):-len("_fc")]
            _dense(sd, f"{prefix}output_layers.{name}.0", p[key])
            _dense(sd, f"{prefix}output_layers.{name}.2", p[f"head_{name}_out"])
    if "extender" in p:
        sd[prefix + "extender.1.weight"] = _t(np.asarray(p["extender"]["kernel"]).T[..., None])
        sd[prefix + "extender.1.bias"] = _t(p["extender"]["bias"])
    if "energy_query" in p:
        sd[prefix + "energy_query"] = _t(p["energy_query"])
        _block(sd, prefix + "energy_block", p["energy_block"])
        _dense(sd, prefix + "energy_mlp.0", p["energy_fc"])
        _dense(sd, prefix + "energy_mlp.2", p["energy_out"])
    if "query" in p:
        sd[prefix + "query"] = _t(p["query"])
    return sd


def first_stage_state_dict_from_jax(params: Mapping, constants: Mapping,
                                    max_res: int = 10) -> Dict[str, torch.Tensor]:
    """flax MD17, peptide, pedestrian or NBA FirstStageBackbone params and
    constants -> port FirstStageBackbone state_dict (the reference
    Backbone's keys). The one entity table lands under both
    ``encoder.entity_embedding`` and ``decoder.entity_embedding``, as in a
    reference state_dict.

    Input embedders: MD17's ``embed_atom``/``embed_pos`` become
    ``embed_atom.weight`` and ``embed_pos.mlp``; the peptide's
    ``embedding_res`` becomes ``embedding_res.weight`` and its fixed sin-cos
    table, which flax keeps as no parameter, the buffer
    ``embed_res_pos.embeddings`` (``max_res`` rows, the config's default
    10); NBA's ``embed_team``/``embed_group`` become ``embed_team.weight``
    and ``embed_group.weight``; the pedestrian's has the merge MLP alone.
    Every merge MLP (``merge_fc``, ``merge_out``) becomes ``net_merge.{0,2}``."""
    from lam_slide_tpu_torch.nn.embeddings import sincos_position_table

    if "params" in params and "encoder" not in params:
        params = params["params"]
    if "constants" in constants:
        constants = constants["constants"]
    emb = params["input_embedder"]
    sd: Dict[str, torch.Tensor] = {}
    if "embedding_res" in emb:
        sd["embedding_res.weight"] = _t(emb["embedding_res"]["embedding"])
        width = np.asarray(emb["merge_out"]["kernel"]).shape[1]
        sd["embed_res_pos.embeddings"] = _t(sincos_position_table(max_res, width))
    elif "embed_atom" in emb:
        sd["embed_atom.weight"] = _t(emb["embed_atom"]["embedding"])
        _dense(sd, "embed_pos.mlp", emb["embed_pos"]["mlp"])
    for name in ("embed_team", "embed_group"):
        if name in emb:
            sd[f"{name}.weight"] = _t(emb[name]["embedding"])
    _dense(sd, "net_merge.0", emb["merge_fc"])
    _dense(sd, "net_merge.2", emb["merge_out"])
    sd.update(encoder_state_dict_from_jax(params["encoder"], "encoder."))
    sd.update(decoder_state_dict_from_jax(params["decoder"], "decoder."))
    _dense(sd, "quant.0", params["quant"])
    _dense(sd, "post_quant.1", params["post_quant"])
    table = _t(constants["embed_entity"]["embedding"])
    sd["encoder.entity_embedding.embedding.weight"] = table
    sd["decoder.entity_embedding.embedding.weight"] = table
    return sd
