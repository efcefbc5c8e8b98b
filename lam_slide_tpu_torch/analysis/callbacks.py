"""In-training evaluation hooks for ``Trainer.eval_fns`` (counterpart of
``lam_slide_tpu/analysis/callbacks.py``).

``make_peptide_sampling_hook`` is the SIAtom14SampleCallback equivalent
(src/callbacks/si_sample_callback.py:168-248): every ``interval`` validation
epochs it rolls out a few trajectories from the current EMA weights,
computes quick torsion/TICA JSD metrics against the reference MD and
optionally saves the summary figure into the run directory. Returned
metric dicts flow into the trainer's JSONL stream.
"""

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_peptide_sampling_hook(
    second_stage,
    trajectories,
    run_dir: str,
    interval: int = 1,
    num_rollouts: int = 2,
    max_peptides: int = 2,
    num_steps: int = 10,
    figures: bool = False,
    seed: int = 137,
):
    """-> hook(state, epoch) for Trainer(eval_fns={...}).

    ``second_stage`` is the run's ``SecondStage`` (its backbone the state's
    model); trajectories: ``PeptideDataset.trajectories`` entries
    (precomputed dicts). The ``RolloutSampler`` (Euler, ``num_steps``) is
    built once, on a second stage whose backbone calls the weights of the
    epoch: the state's EMA (its parameters without one), swapped in by
    ``train.steps.on_weights``. Epoch e's noise comes from a
    ``torch.Generator`` on the sampler's device seeded ``seed + e``, the
    trajectories drawn one after another from it.
    """
    from lam_slide_tpu_torch.analysis import rollout
    from lam_slide_tpu_torch.analysis.eval_peptide import EvalConfig, evaluate_peptides
    from lam_slide_tpu_torch.train.steps import on_weights

    counter = {"n": 0}
    cache: Dict[str, object] = {}
    current = {"backbone": second_stage.backbone}

    def backbone(*args, **kwargs):
        return current["backbone"](*args, **kwargs)

    def hook(state, epoch) -> Optional[Dict[str, float]]:
        counter["n"] += 1
        if (counter["n"] - 1) % interval != 0:
            return None
        if "sampler" not in cache:
            cache["sampler"] = rollout.RolloutSampler(
                dataclasses.replace(second_stage, backbone=backbone),
                sampling_kwargs={"sampling_method": "euler", "num_steps": num_steps})
        sampler = cache["sampler"]
        generator = torch.Generator(device=sampler.device).manual_seed(seed + epoch)
        samples = {}
        with on_weights(second_stage.backbone, state.ema_params) as weights:
            current["backbone"] = weights
            try:
                for traj in trajectories[:max_peptides]:
                    try:
                        gen = sampler.sample_rollout(
                            generator, traj["atom14_pos"][0], traj["aatype"][0],
                            traj["atom14_mask"][0], num_rollouts=num_rollouts)
                        samples[traj["name"]] = {"traj": gen, "ref": traj["atom14_pos"],
                                                 "aatype": traj["aatype"][0]}
                    except Exception as e:  # si_sample_callback.py:223-233
                        print(f"sampling hook failed for {traj['name']}: {e!r}")
            finally:
                current["backbone"] = second_stage.backbone
        if not samples:
            return None
        t_ref = min(len(t["ref"]) for t in samples.values())
        cfg = EvalConfig(tica_lag=min(1000, t_ref // 2), run_msm=False,
                         run_decorrelation=False)
        per, summary = evaluate_peptides(samples, cfg)
        if figures:
            from lam_slide_tpu_torch.analysis.plots import eval_summary_figure

            os.makedirs(os.path.join(run_dir, "figures"), exist_ok=True)
            eval_summary_figure(
                per, path=os.path.join(run_dir, "figures", f"epoch{epoch}.png"))
        return summary

    return hook


def make_pointcloud_vis_hook(
    predict_fn,
    batch: Dict[str, np.ndarray],
    run_dir: str,
    atom_types: Optional[np.ndarray] = None,
    ax_range=(-1, 1),
    interval: int = 1,
):
    """PointCloudVisualizationCallback equivalent (src/modules/callbacks.py):
    every ``interval`` validation epochs, render the first validation
    sample's predicted vs target point cloud (open diamonds = ground truth)
    into ``run_dir/figures`` — the figure-logging stand-in for the
    reference's wandb ``val/vis/sample`` — and return its ``vis_rmse``.

    predict_fn(state, batch) -> positions [B, N, 3] (a tensor or an array,
    e.g. a stage-1 reconstruction); batch carries "pos" targets +
    "attention_mask". matplotlib is imported when the first figure is drawn.
    """
    from lam_slide_tpu_torch.data.constants import NUM_TO_ATOM_TYPE

    outdir = os.path.join(run_dir, "figures")
    counter = {"n": 0}

    def hook(state, epoch) -> Optional[Dict[str, float]]:
        from lam_slide_tpu_torch.analysis.plots import _pyplot, scatter_3d_comparison

        counter["n"] += 1
        if (counter["n"] - 1) % interval != 0:
            return None
        preds = _numpy(predict_fn(state, batch))
        mask = _numpy(batch["attention_mask"][0]).astype(bool)
        target = _numpy(batch["pos"][0])
        types = None
        if atom_types is not None:
            types = [NUM_TO_ATOM_TYPE.get(int(z), "#") for z in np.asarray(atom_types)[mask]]
        fig = scatter_3d_comparison(
            preds[0][mask], types, target[mask], types,
            ax_range=ax_range, title=f"epoch {epoch}",
        )
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"pointcloud_epoch{epoch:05d}.png")
        fig.savefig(path, dpi=110)
        _pyplot().close(fig)
        rmse = float(np.sqrt(np.mean((preds[0][mask] - target[mask]) ** 2)))
        return {"vis_rmse": rmse}

    return hook
