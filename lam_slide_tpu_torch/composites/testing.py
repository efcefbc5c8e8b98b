"""Domain test protocols (counterpart of ``lam_slide_tpu/composites/testing.py``;
the MD17 protocol, on one card with no mesh).

MD17 (second_stage/md17.py:139-179): zero the target frames, sample K=5
repeats with the Euler-10 probability-flow ODE, decode, and average the
per-repeat ADE/FDE of the predicted frames, times the dataset scale, per
molecule. ``make_protocol_val_hook`` runs that protocol on a train state's
EMA weights (its parameters when it keeps no EMA) as the stage-2
validation of the ``Trainer``, every ``interval`` val epochs (the
pedestrian and NBA protocols come with their slices).
"""

import dataclasses
import itertools
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from lam_slide_tpu_torch.composites.evaluation import mean_over_k_ade_fde, zero_target_frames


def evaluate_md17(ss, loaders: Mapping[str, Iterable], scale: float, k: int = 5,
                  generator: Optional[torch.Generator] = None,
                  sampling_kwargs: Optional[dict] = None,
                  k_chunk: Optional[int] = None) -> Dict[str, float]:
    """-> {"test/<molecule>/ade": ..., "test/<molecule>/fde": ...}.

    ``loaders`` maps a molecule name to an iterable of batches (dicts of
    arrays or tensors in the MD17 stage-2 layout); the batches move to the
    first stage's device. ``generator`` draws the initial noise (a generator
    on that device; seed 0 when none is given)."""
    device = next(ss.first_stage.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cond_end = ss.cond_idx[1]
    sample_k = ss.make_k_sample_fn(
        k=k, k_chunk=k_chunk, sampling_method="ODE",
        sampling_kwargs=sampling_kwargs or {"sampling_method": "euler", "num_steps": 10})
    out = {}
    for name, loader in loaders.items():
        ades, fdes = [], []
        for batch in loader:
            batch = {key: torch.as_tensor(val, device=device) for key, val in batch.items()}
            true_pos = batch["pos"][:, cond_end:]
            mask = batch["attention_mask"][:, cond_end:]
            preds = sample_k(zero_target_frames(batch, cond_end), generator=generator)
            ade, fde = mean_over_k_ade_fde(preds["pos"][:, :, cond_end:], true_pos, mask)
            ades.append(ade)
            fdes.append(fde)
        out[f"test/{name}/ade"] = float(torch.cat(ades).mean()) * scale
        out[f"test/{name}/fde"] = float(torch.cat(fdes).mean()) * scale
    return out


def make_protocol_val_hook(ss, loaders: Mapping[str, Iterable], scale: float = 1.0, k: int = 5,
                           limit_batches: int = 1, interval: int = 1,
                           sampling_kwargs: Optional[dict] = None):
    """Trainer eval hook (composites/testing.py:172-209): ``hook(state,
    epoch)`` -> {"ade", "fde"} every ``interval``-th call (None on the
    others), the means over the loaders of the MD17 protocol
    (``evaluate_md17``) on ``state.ema_params`` (``state.params`` when the
    state keeps no EMA) over the first ``limit_batches`` batches of each
    loader, the reference's stage-2 validation_step
    (second_stage/md17.py:75-113). ``state.model`` is ``ss.backbone``; the
    noise of epoch e is drawn from seed 1234 + e on the first stage's
    device."""
    device = next(ss.first_stage.parameters()).device
    calls = [0]

    def hook(state, epoch: int):
        calls[0] += 1
        if (calls[0] - 1) % interval:
            return None
        backbone = ss.backbone
        weights = state.ema_params if state.ema_params is not None else state.params

        def on_weights(*args, **kwargs):
            return functional_call(backbone, weights, args, kwargs)

        limited = {name: itertools.islice(loader, limit_batches)
                   for name, loader in loaders.items()}
        out = evaluate_md17(dataclasses.replace(ss, backbone=on_weights), limited, scale=scale, k=k,
                            generator=torch.Generator(device=device).manual_seed(1234 + epoch),
                            sampling_kwargs=sampling_kwargs)
        ades = [v for key, v in out.items() if key.endswith("/ade")]
        fdes = [v for key, v in out.items() if key.endswith("/fde")]
        return {"ade": float(np.mean(ades)), "fde": float(np.mean(fdes))}

    return hook
