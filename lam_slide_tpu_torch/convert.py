"""JAX param tree -> port state_dict (the reverse of ``train/torch_import.py``).

``latent_dit_state_dict_from_jax`` takes a flax ``LatentDiT`` param tree as
nested mappings of numpy arrays (unrolled ``block_i`` layout, or the
``blocks/layer`` scan layout with a leading depth axis) and returns the
port's ``LatentDiT`` state_dict. flax Dense kernels ``[in, out]`` become
torch Linear weights ``[out, in]``.
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
    if "block_shared" in params:
        raise NotImplementedError("share_weights checkpoints are not ported yet")
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

    if "blocks" in params:  # scan layout: blocks/layer/... with a leading depth axis
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
