"""4AA peptide evaluation CLI (counterpart of
``lam_slide_tpu/analysis/eval_cli.py``; the reference's src/eval_peptide.py).

    python -m lam_slide_tpu_torch.analysis.eval_cli --run <stage2_run_id> \\
        --workspace runs [--data-root data/4AA_sims_partial] \\
        [--num-rollouts 10] [--pdb-ids AAAA BBBB] [--batch-peptides]

Loads the trained stage-2 run from the port's run registry (EMA weights;
the frozen stage 1 rides in its checkpoint's constants), casts every
weight to fp32 and builds the fp32 DiT ("fp32 sampling of the
bf16-trained model", configs/eval_peptide.yaml:19-25), samples
``num_rollouts`` chained windows per test peptide with the dopri5 (or
Euler/Heun) ODE sampler on the card (``--device``), writes multi-model PDB
trajectories, runs the torsion/TICA/MSM JSD analysis against the reference
MD, writes ``metrics.json`` and prints the BB/SC/ALL/TICA/MSMS summary as
one JSON line.
"""

import argparse
import json
import os
import sys
import time

NO_MATPLOTLIB = "--figures draws with matplotlib, which is not installed here"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", required=True, help="stage-2 run id in the registry")
    p.add_argument("--workspace", default="runs")
    p.add_argument("--data-root", default=None, help="4AA data dir (test split)")
    p.add_argument("--num-rollouts", type=int, default=10)
    p.add_argument("--pdb-ids", nargs="*", default=None)
    p.add_argument("--sampling-method", default="dopri5", choices=["euler", "heun", "dopri5"],
                   help="default dopri5 atol 1e-6 / rtol 1e-3, the reference eval protocol "
                        "(configs/eval_peptide.yaml:23); euler/10 is the training-time val "
                        "sampler")
    p.add_argument("--num-steps", type=int, default=10)
    p.add_argument("--atol", type=float, default=1e-6)
    p.add_argument("--rtol", type=float, default=1e-3)
    p.add_argument("--truncate", type=int, default=None)
    p.add_argument("--no-msm", action="store_true")
    p.add_argument("--no-decorr", action="store_true")
    p.add_argument("--figures", action="store_true",
                   help="also write the per-peptide summary figure (analysis/plots.py, "
                        "needs matplotlib) as summary.png")
    p.add_argument("--outdir", default=None)
    p.add_argument("--batch-peptides", action="store_true",
                   help="sample every test peptide in one batched solve per rollout window "
                        "instead of the reference's serial per-peptide loop "
                        "(eval_peptide.py:352-367): the same protocol (rollouts, windows, "
                        "solver); a window's noise draw is shared across the batch, so "
                        "per-peptide samples differ from a serial run's")
    p.add_argument("--unroll", action="store_true",
                   help="accepted for the JAX CLI's command lines and changes nothing: the "
                        "port's checkpoints have one DiT layout")
    p.add_argument("--control", action="store_true",
                   help="random-model control: discard the trained DiT weights and sample "
                        "from a fresh random init (same architecture, same frozen stage 1); "
                        "the JSD gap between the normal run and this arm is the evidence "
                        "that training, not the pipeline, produces the fidelity numbers")
    p.add_argument("--device", default="cuda",
                   help="torch device the eval samples on (default: the card)")
    args = p.parse_args(argv)
    if args.figures:
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            raise SystemExit(NO_MATPLOTLIB)

    import numpy as np
    import torch

    from lam_slide_tpu_torch.analysis.eval_peptide import EvalConfig, evaluate_peptides
    from lam_slide_tpu_torch.analysis.rollout import RolloutSampler
    from lam_slide_tpu_torch.composites.peptide import (
        PeptideFirstStageConfig,
        PeptideSecondStageConfig,
        build_peptide_first_stage,
        build_peptide_second_stage,
    )
    from lam_slide_tpu_torch.data.peptide import PeptideDataset
    from lam_slide_tpu_torch.experiments.registry import load_checkpoint_raw
    from lam_slide_tpu_torch.geometry.protein import atom14_to_pdb
    from lam_slide_tpu_torch.train.checkpoint import resolve_run
    from lam_slide_tpu_torch.utils.trees import tree_to_f32

    info = resolve_run(args.workspace, args.run)
    meta = info.get("config", {})
    cfg2 = PeptideSecondStageConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta.get("config", {}).items()
        if k in PeptideSecondStageConfig.__dataclass_fields__})
    raw = load_checkpoint_raw(info["run_dir"], "best")
    # fp32 sampling of the bf16-trained model: the EMA over the trained
    # state dict, and the frozen stage 1, every floating tensor cast up
    params = tree_to_f32({**raw["params"], **(raw.get("ema_params") or {})})
    fs_state = tree_to_f32(raw["constants"]["first_stage"])

    fs_cfg_src = {}
    if meta.get("first_stage_run"):
        fs_cfg_src = resolve_run(args.workspace, meta["first_stage_run"]).get(
            "config", {}).get("config", {})
    fs_cfg = PeptideFirstStageConfig(**{
        k: v for k, v in fs_cfg_src.items() if k in PeptideFirstStageConfig.__dataclass_fields__})
    fs_model = build_peptide_first_stage(fs_cfg, device=args.device)
    fs_model.load_state_dict(fs_state)
    control_seed = 20260820
    ss = build_peptide_second_stage(cfg2, fs_model, device=args.device,
                                    generator=torch.Generator().manual_seed(control_seed))
    if args.control:
        print("CONTROL ARM: sampling from a RANDOM-INIT model", flush=True)
    else:
        ss.backbone.load_state_dict(params)
    ss.backbone.eval()

    sampler = RolloutSampler(
        ss, sampling_kwargs=(
            {"sampling_method": "dopri5", "atol": args.atol, "rtol": args.rtol}
            if args.sampling_method == "dopri5"
            else {"sampling_method": args.sampling_method, "num_steps": args.num_steps}))

    ds = PeptideDataset(
        data_dir=args.data_root, first_stage=False, n_timesteps=cfg2.num_timesteps,
        num_entities=fs_cfg.num_entities,
        # reference trajectories in the run's normalized coordinate units
        # (torsion/TICA/MSM JSD are invariant to the uniform scale; the
        # conditioning frames fed to the sampler must match training units)
        scale=fs_cfg.scale, shift=fs_cfg.shift,
        synthetic_frames=max(4 * cfg2.num_timesteps, 200),
        # reference trajectories from the generator the run was trained on
        synthetic_version=int(meta.get("launch", {}).get("exp_overrides", {}).get(
            "synthetic_version", 1)))
    outdir = args.outdir or os.path.join(info["run_dir"],
                                         "eval_control" if args.control else "eval")
    os.makedirs(outdir, exist_ok=True)

    available = [t["name"] for t in ds.trajectories]
    if args.pdb_ids:
        missing = sorted(set(args.pdb_ids) - set(available))
        if missing:
            raise SystemExit(f"--pdb-ids not found: {missing}; available: {available}")

    generator = torch.Generator(device=sampler.device).manual_seed(137)
    samples = {}
    selected = [t for t in ds.trajectories if not args.pdb_ids or t["name"] in args.pdb_ids]
    if args.batch_peptides:
        t0 = time.time()
        gen_all = sampler.sample_rollout_batched(
            generator, np.stack([t["atom14_pos"][0] for t in selected]),
            np.stack([t["aatype"][0] for t in selected]),
            np.stack([t["atom14_mask"][0] for t in selected]), num_rollouts=args.num_rollouts)
        wall = time.time() - t0
        print(f"sampled {len(selected)} peptides batched: {gen_all.shape[1]} frames each in "
              f"{wall:.1f}s ({wall / len(selected):.1f}s/peptide)")
        for traj, gen in zip(selected, gen_all):
            res = traj["aatype"][0]
            atom14_to_pdb(gen[::max(len(gen) // 50, 1)], res,
                          os.path.join(outdir, f"{traj['name']}.pdb"))
            samples[traj["name"]] = {"traj": gen, "ref": traj["atom14_pos"], "aatype": res}
    else:
        for traj in selected:
            name = traj["name"]
            t0 = time.time()
            res = traj["aatype"][0]
            gen = sampler.sample_rollout(generator, traj["atom14_pos"][0], res,
                                         traj["atom14_mask"][0], num_rollouts=args.num_rollouts)
            print(f"sampled {name}: {gen.shape[0]} frames in {time.time() - t0:.1f}s")
            atom14_to_pdb(gen[::max(len(gen) // 50, 1)], res, os.path.join(outdir, f"{name}.pdb"))
            samples[name] = {"traj": gen, "ref": traj["atom14_pos"], "aatype": res}

    cfg = EvalConfig(truncate=args.truncate, run_msm=not args.no_msm,
                     run_decorrelation=not args.no_decorr)
    per, summary = evaluate_peptides(samples, cfg)
    if args.figures:
        from lam_slide_tpu_torch.analysis.plots import eval_summary_figure

        eval_summary_figure(per, path=os.path.join(outdir, "summary.png"))
    with open(os.path.join(outdir, "metrics.json"), "w") as f:
        json.dump({"summary": summary, "per_peptide": {k: v["JSD"] for k, v in per.items()}},
                  f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
