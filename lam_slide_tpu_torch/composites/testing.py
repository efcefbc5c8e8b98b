"""Domain test protocols (counterpart of ``lam_slide_tpu/composites/testing.py``).

Pass ``mesh`` (parallel/mesh.py) to shard evaluation over its data axis:
each rank samples its rows of a test batch (``shard_batch``) with the
noise a one-rank run draws for them (``parallel.rows.use_rows``), and the
metrics are reduced over the ranks (MD17's per-sample errors gathered, the
min-over-K means averaged with the global entity count), so a sharded run
gives the one-rank metrics; a batch whose size the data axis does not
divide runs whole on every rank, as JAX runs it replicated.

* MD17 (second_stage/md17.py:139-179): zero the target frames, sample K=5
  repeats with the Euler-10 probability-flow ODE, decode, and average the
  per-repeat ADE/FDE of the predicted frames, times the dataset scale, per
  molecule (``evaluate_md17``).
* Pedestrian (second_stage/pedestrian.py:148-239) and NBA: per-entity
  trajectories, the min over ``num_runs`` of K samples (K=20 / K=60), with
  the k-means final-position clustering when ``post_process``; times the
  scale, per scene (``evaluate_min_k``).

``make_protocol_val_hook`` runs a domain's protocol on a train state's EMA
weights (its parameters when it keeps no EMA) as the stage-2 validation of
the ``Trainer``, every ``interval`` val epochs.
"""

import dataclasses
import itertools
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from lam_slide_tpu_torch.composites.evaluation import (
    mean_over_k_ade_fde,
    per_entity_min_k_ade_fde,
    zero_target_frames,
)
from lam_slide_tpu_torch.parallel.mesh import shard_batch
from lam_slide_tpu_torch.parallel.rows import use_rows


def _sample_k_fn(ss, k, k_chunk, sampling_kwargs):
    return ss.make_k_sample_fn(
        k=k, k_chunk=k_chunk, sampling_method="ODE",
        sampling_kwargs=sampling_kwargs or {"sampling_method": "euler", "num_steps": 10})


def _on_device(batch, device, mesh, loader):
    """-> (this rank's part of ``batch`` on ``device``, its rows or None)."""
    rows = None
    if mesh is not None:
        batch = shard_batch(batch, mesh,
                            full_local=getattr(loader, "process_shard", None) is None)
        rows = batch.rows
    return {key: torch.as_tensor(val, device=device) for key, val in batch.items()}, rows


def _gather(t: torch.Tensor, rows) -> torch.Tensor:
    """Every rank's rows of ``t`` (axis 0) in rank order: the global batch's."""
    if rows is None:
        return t
    parts = [torch.empty_like(t) for _ in range(rows.size)]
    dist.all_gather(parts, t.contiguous(), group=rows.group)
    return torch.cat(parts)


def _rank_mean(t: torch.Tensor, rows) -> torch.Tensor:
    if rows is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=rows.group)
    return t / rows.size


def evaluate_md17(ss, loaders: Mapping[str, Iterable], scale: float, k: int = 5,
                  generator: Optional[torch.Generator] = None,
                  sampling_kwargs: Optional[dict] = None,
                  k_chunk: Optional[int] = None, mesh=None) -> Dict[str, float]:
    """-> {"test/<molecule>/ade": ..., "test/<molecule>/fde": ...}.

    ``loaders`` maps a molecule name to an iterable of batches (dicts of
    arrays or tensors in the MD17 stage-2 layout); the batches move to the
    first stage's device. ``generator`` draws the initial noise (a generator
    on that device; seed 0 when none is given). ``mesh``: shard each batch
    over its data axis (module docstring)."""
    device = next(ss.first_stage.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cond_end = ss.cond_idx[1]
    sample_k = _sample_k_fn(ss, k, k_chunk, sampling_kwargs)
    out = {}
    for name, loader in loaders.items():
        ades, fdes = [], []
        for batch in loader:
            batch, rows = _on_device(batch, device, mesh, loader)
            true_pos = batch["pos"][:, cond_end:]
            mask = batch["attention_mask"][:, cond_end:]
            with use_rows(rows):
                preds = sample_k(zero_target_frames(batch, cond_end), generator=generator)
            ade, fde = mean_over_k_ade_fde(preds["pos"][:, :, cond_end:], true_pos, mask)
            ades.append(_gather(ade, rows))
            fdes.append(_gather(fde, rows))
        out[f"test/{name}/ade"] = float(torch.cat(ades).mean()) * scale
        out[f"test/{name}/fde"] = float(torch.cat(fdes).mean()) * scale
    return out


def evaluate_min_k(ss, loaders: Mapping[str, Iterable], scale: float = 1.0, k: int = 20,
                   num_runs: int = 20, post_process: bool = False,
                   generator: Optional[torch.Generator] = None,
                   sampling_kwargs: Optional[dict] = None, pos_key: str = "pos",
                   k_chunk: Optional[int] = None, mesh=None) -> Dict[str, float]:
    """Pedestrian/NBA protocol -> {"test/<scene>/ade", "test/<scene>/fde"}
    and, with ``post_process`` (FPC), also ``.../ade_post`` and
    ``.../fde_post``: per batch the per-entity min over the first
    ``num_runs`` of K samples (and over the FPC picks), then the mean over
    the batches, times ``scale``. Batches, ``generator`` and ``mesh`` as in
    ``evaluate_md17``."""
    if k < num_runs:
        raise ValueError("K must be >= num_runs (second_stage/pedestrian.py:44-47)")
    device = next(ss.first_stage.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cond_end = ss.cond_idx[1]
    sample_k = _sample_k_fn(ss, k, k_chunk, sampling_kwargs)
    out = {}
    for name, loader in loaders.items():
        accum = {"ade": [], "fde": [], "ade_post": [], "fde_post": []}
        for batch in loader:
            batch, rows = _on_device(batch, device, mesh, loader)
            true_pos = batch[pos_key][:, cond_end:]
            emask = batch["attention_mask"][:, 0]
            with use_rows(rows):
                preds = sample_k(zero_target_frames(batch, cond_end, keys=(pos_key,)),
                                 generator=generator)
                pred_k = preds[pos_key][:, :, cond_end:]
                got = {"ade": per_entity_min_k_ade_fde(pred_k, true_pos, emask,
                                                       num_runs=num_runs)}
                if post_process:
                    got["post"] = per_entity_min_k_ade_fde(pred_k, true_pos, emask,
                                                           num_runs=num_runs, fpc=True)
            for key, (ade, fde) in got.items():
                suffix = "" if key == "ade" else "_post"
                accum["ade" + suffix].append(float(_rank_mean(ade, rows)))
                accum["fde" + suffix].append(float(_rank_mean(fde, rows)))
        keys = ("ade", "fde", "ade_post", "fde_post") if post_process else ("ade", "fde")
        out.update({f"test/{name}/{key}": float(np.mean(accum[key]) * scale) for key in keys})
    return out


def make_protocol_val_hook(ss, loaders: Mapping[str, Iterable], domain: str = "md17",
                           scale: float = 1.0, k: int = 5, num_runs: Optional[int] = None,
                           limit_batches: int = 1, interval: int = 1,
                           sampling_kwargs: Optional[dict] = None):
    """Trainer eval hook (composites/testing.py:172-209): ``hook(state,
    epoch)`` -> {"ade", "fde"} every ``interval``-th call (None on the
    others), the means over the loaders of the domain's protocol
    (``evaluate_md17`` for "md17", else ``evaluate_min_k`` with ``num_runs``,
    K by default) on ``state.ema_params`` (``state.params`` when the state
    keeps no EMA) over the first ``limit_batches`` batches of each loader,
    the reference's stage-2 validation_step (second_stage/md17.py:75-113,
    pedestrian.py:148-190). ``state.model`` is ``ss.backbone``; the noise of
    epoch e is drawn from seed 1234 + e on the first stage's device."""
    device = next(ss.first_stage.parameters()).device
    calls = [0]

    def hook(state, epoch: int):
        calls[0] += 1
        if (calls[0] - 1) % interval:
            return None
        from lam_slide_tpu_torch.train.steps import on_weights

        limited = {name: itertools.islice(loader, limit_batches)
                   for name, loader in loaders.items()}
        generator = torch.Generator(device=device).manual_seed(1234 + epoch)
        with on_weights(ss.backbone, state.ema_params) as backbone:
            on_ss = dataclasses.replace(ss, backbone=backbone)
            if domain == "md17":
                out = evaluate_md17(on_ss, limited, scale=scale, k=k, generator=generator,
                                    sampling_kwargs=sampling_kwargs)
            else:
                out = evaluate_min_k(on_ss, limited, scale=scale, k=k, num_runs=num_runs or k,
                                     generator=generator, sampling_kwargs=sampling_kwargs)
        ades = [v for key, v in out.items() if key.endswith("/ade")]
        fdes = [v for key, v in out.items() if key.endswith("/fde")]
        return {"ade": float(np.mean(ades)), "fde": float(np.mean(fdes))}

    return hook
