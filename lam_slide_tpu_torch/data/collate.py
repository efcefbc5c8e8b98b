"""Static-shape batch collation (copied from ``lam_slide_tpu/data/collate.py``).

The reference pads each batch to its per-batch max entity count
(src/datasets/collate_functions.py:19-116). Here every dataset declares a
static ``num_entities`` and all batches pad to it; masks carry the true
sizes. ``attention_mask[b, n] = True`` for real entities (derived in the
reference from nonzero features; here exactly from sample lengths).
"""

from typing import Dict, Sequence

import numpy as np


def _pad_axis0(arr: np.ndarray, target: int) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    if arr.shape[0] > target:
        raise ValueError(f"sample has {arr.shape[0]} entities > static budget {target}")
    pad = [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def pad_collate(samples: Sequence[Dict[str, np.ndarray]],
                num_entities: int) -> Dict[str, np.ndarray]:
    """Stage-1 collate (CollatePadBatch semantics, collate_functions.py:19-43).

    Per sample: dict of per-entity arrays with entity axis 0 (e.g. pos [N, 3],
    atom [N], entities [N]) and optional non-entity keys prefixed ``cond``
    or scalars. Returns stacked arrays padded to ``num_entities`` plus
    ``attention_mask`` [B, num_entities].
    """
    out: Dict[str, np.ndarray] = {}
    n_real = np.asarray([len(s["entities"]) for s in samples], dtype=np.int32)
    for key in samples[0]:
        vals = [np.asarray(s[key]) for s in samples]
        if key.startswith("cond") or vals[0].ndim == 0:
            out[key] = np.stack(vals)
        else:
            out[key] = np.stack([_pad_axis0(v, num_entities) for v in vals])
    mask = np.arange(num_entities)[None, :] < n_real[:, None]
    out["attention_mask"] = mask
    return out


def pad_collate_temporal(
    samples: Sequence[Dict[str, np.ndarray]], num_entities: int
) -> Dict[str, np.ndarray]:
    """Stage-2 collate (CollatePadBatchTemp semantics, collate_functions.py:46-116).

    Per sample: arrays with leading time axis and entity axis 1
    (pos [T, N, 3], atom [T, N], entities [T, N]). Pads the entity axis to
    the static budget; ``attention_mask`` is [B, T, num_entities].
    """
    out: Dict[str, np.ndarray] = {}
    n_real = np.asarray([s["entities"].shape[1] for s in samples], dtype=np.int32)
    t_len = np.asarray(samples[0]["entities"]).shape[0]
    for key in samples[0]:
        vals = [np.asarray(s[key]) for s in samples]
        if key.startswith("cond") or vals[0].ndim == 0:
            out[key] = np.stack(vals)
        else:
            padded = []
            for v in vals:
                if v.ndim < 2:
                    padded.append(v)
                    continue
                pad = [(0, 0), (0, num_entities - v.shape[1])] + [(0, 0)] * (v.ndim - 2)
                padded.append(np.pad(v, pad))
            out[key] = np.stack(padded)
    mask = np.arange(num_entities)[None, None, :] < n_real[:, None, None]
    out["attention_mask"] = np.broadcast_to(mask, (len(samples), t_len, num_entities)).copy()
    return out
