"""Domain test protocols (counterpart of ``lam_slide_tpu/composites/testing.py``;
the MD17 protocol, on one card with no mesh).

MD17 (second_stage/md17.py:139-179): zero the target frames, sample K=5
repeats with the Euler-10 probability-flow ODE, decode, and average the
per-repeat ADE/FDE of the predicted frames, times the dataset scale, per
molecule.
"""

from typing import Dict, Iterable, Mapping, Optional

import torch

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
