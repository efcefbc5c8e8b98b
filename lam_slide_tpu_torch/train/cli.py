"""Training CLI (counterpart of ``lam_slide_tpu/train/cli.py``; the
reference's src/train.py).

    python -m lam_slide_tpu_torch.train.cli --experiment md17_first_stage --smoke
    python -m lam_slide_tpu_torch.train.cli --experiment md17_second_stage \\
        --first-stage-run <run_id> --workspace runs --data-root data/md17 --test
    python -m lam_slide_tpu_torch.train.cli --experiment nba_first_stage --scene score \
        --run-id n1
    python -m lam_slide_tpu_torch.train.cli --experiment nba_second_stage \
        --first-stage-run n1 --run-id n2 --test
    python -m lam_slide_tpu_torch.train.cli --experiment peptide_first_stage --run-id p1
    python -m lam_slide_tpu_torch.train.cli --experiment peptide_second_stage \\
        --first-stage-run p1 --run-id p2
    python -m lam_slide_tpu_torch.analysis.eval_cli --run p2

Runs go under <workspace>/<run_id>/ with metrics.jsonl and
checkpoints/{best,last}.pt; every run is recorded in the workspace's run
registry, so a stage-2 experiment resolves its frozen stage 1 by
--first-stage-run (replacing the reference's wandb lineage). ``--test``
runs the domain test protocol after training, ``--test-only`` on a
finished run's checkpoint (md17's mean over K, the pedestrian and NBA
min over K with NBA's final-position clustering; a peptide stage-2 run
prints the pointer to ``analysis.eval_cli``, the 4AA eval pipeline). Everything runs on one CUDA card (``--device``
picks another device, such as ``cpu``); the multi-device flags wait for
the port's ``parallel/``.
"""

import argparse
import json
import os
import secrets
import sys

PARALLEL_TODO = ("needs the port's parallel/, which is not ported yet (ROADMAP.md Queue 1, "
                 "the parallel/ item)")


def _parse_value(raw: str):
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            return {"true": True, "false": False}.get(raw.lower(), raw)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", default=None,
                        help="experiment name (required unless --test-only recovers it from "
                             "the run registry)")
    parser.add_argument("--smoke", action="store_true", help="tiny synthetic run (debug cfg)")
    parser.add_argument("--workspace", default="runs")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--run-id", default=None)
    parser.add_argument("--first-stage-run", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=None, help="override max_epochs")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device the run builds its models on (default: the card)")
    parser.add_argument("--no-mesh", action="store_true",
                        help="accepted for the JAX CLI's command lines; one device either way")
    parser.add_argument("--model-axis", type=int, default=1, help=f"> 1 {PARALLEL_TODO}")
    parser.add_argument("--fsdp", action="store_true", help=PARALLEL_TODO)
    parser.add_argument("--devices", type=int, default=None, help=PARALLEL_TODO)
    parser.add_argument("--multihost", action="store_true", help=PARALLEL_TODO)
    parser.add_argument("--test-mesh", action="store_true", help=PARALLEL_TODO)
    parser.add_argument("--molecule", default=None,
                        help="md17: molecule or 'all' (default; --test-only recovers the "
                             "trained run's value)")
    parser.add_argument("--scene", default=None,
                        help="nba: score|rebound (default score; --test-only recovers the "
                             "trained run's value)")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="override TrainerConfig fields (e.g. --set lr=2e-4)")
    parser.add_argument("--exp-set", dest="exp_overrides", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="extra keyword overrides passed to the experiment builder "
                             "(e.g. --exp-set batch_size=16)")
    parser.add_argument("--test", action="store_true",
                        help="after training, run the domain test protocol on the test split "
                             "(mean-K ADE/FDE for md17, per-entity min-K for pedestrian and "
                             "nba)")
    parser.add_argument("--test-only", action="store_true",
                        help="skip training: restore --run-id's checkpoint and run the domain "
                             "test protocol")
    parser.add_argument("--test-ckpt", choices=("last", "best"), default="last",
                        help="which checkpoint --test-only restores (src/train.py test_ckpt)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="mirror the metric stream into TensorBoard event files under "
                             "<run_dir>/tb (train/sinks.py)")
    parser.add_argument("--wandb-project", default=None,
                        help="mirror the metric stream to a wandb run (needs wandb)")
    args = parser.parse_args(argv)

    refused = [flag for flag, on in (("--model-axis > 1", args.model_axis > 1),
                                     ("--fsdp", args.fsdp), ("--devices", args.devices),
                                     ("--multihost", args.multihost),
                                     ("--test-mesh", args.test_mesh)) if on]
    if refused:
        raise SystemExit(f"{', '.join(refused)}: {PARALLEL_TODO}")

    from lam_slide_tpu_torch.experiments.registry import build_experiment
    from lam_slide_tpu_torch.train.checkpoint import register_run, resolve_run
    from lam_slide_tpu_torch.train.trainer import Trainer

    run_id = args.run_id or secrets.token_hex(4)
    run_dir = os.path.join(args.workspace, run_id)
    print(f"run_id={run_id} device={args.device}")
    exp_kwargs = {}
    for item in args.exp_overrides:
        key, _, raw = item.partition("=")
        exp_kwargs[key] = _parse_value(raw)

    if args.test_only:
        # standalone test from a checkpoint: recover the finished run's
        # launch configuration (experiment, data selection, overrides, stage
        # lineage) from the registry, so the protocol runs with the settings
        # the checkpoint was trained with; explicit flags still override
        if not args.run_id:
            raise SystemExit("--test-only requires --run-id of a finished run")
        info = resolve_run(args.workspace, run_id)
        run_dir = info["run_dir"]
        stored = info.get("config", {})
        launch = stored.get("launch", {})
        for name in ("experiment", "molecule", "scene", "data_root", "first_stage_run"):
            if getattr(args, name) is None and launch.get(name) is not None:
                setattr(args, name, launch[name])
        if launch.get("smoke") and not args.smoke:
            args.smoke = True
        exp_kwargs = {**launch.get("exp_overrides", {}), **exp_kwargs}
        if args.first_stage_run is None:
            args.first_stage_run = stored.get("first_stage_run")
        mismatches = {f: (launch[f], getattr(args, f))
                      for f in ("experiment", "molecule", "scene")
                      if launch.get(f) is not None and getattr(args, f) != launch[f]}
        if mismatches:
            print(f"WARNING: --test-only overrides the trained run's settings: {mismatches}")

    if not args.experiment:
        raise SystemExit("--experiment is required (no stored value found)")
    molecule = args.molecule if args.molecule is not None else "all"
    scene = args.scene if args.scene is not None else "score"

    exp = build_experiment(args.experiment, smoke=args.smoke, data_root=args.data_root,
                           workspace=args.workspace, seed=args.seed,
                           first_stage_run=args.first_stage_run, molecule=molecule,
                           scene=scene, device=args.device, **exp_kwargs)
    if args.epochs is not None:
        exp.trainer_cfg.max_epochs = args.epochs
    for item in args.overrides:
        key, _, raw = item.partition("=")
        if not hasattr(exp.trainer_cfg, key):
            raise SystemExit(f"--set: unknown TrainerConfig field {key!r}")
        cur = getattr(exp.trainer_cfg, key)
        if isinstance(cur, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(float(raw))
        elif isinstance(cur, float) or cur is None:
            val = float(raw)
        else:
            val = raw
        setattr(exp.trainer_cfg, key, val)

    if args.test_only:
        from lam_slide_tpu_torch.experiments.registry import load_checkpoint_raw

        raw = load_checkpoint_raw(run_dir, which=args.test_ckpt)
        params = {**raw["params"], **(raw.get("ema_params") or {})}
        fs_state = (raw.get("constants") or {}).get("first_stage")
        _run_test_protocol(args, exp, params, fs_state, run_dir, molecule)
        print(f"done: test-only step={int(raw['step'])} run_dir={run_dir}")
        return 0

    register_run(args.workspace, run_id, run_dir, {
        **exp.meta,
        "launch": {
            "experiment": args.experiment, "molecule": molecule, "scene": scene,
            "smoke": bool(args.smoke), "data_root": args.data_root, "seed": args.seed,
            "first_stage_run": args.first_stage_run, "exp_overrides": exp_kwargs,
        },
    })
    sinks = []
    if args.tensorboard:
        from lam_slide_tpu_torch.train.sinks import TensorBoardSink

        sinks.append(TensorBoardSink(os.path.join(run_dir, "tb")))
    if args.wandb_project:
        from lam_slide_tpu_torch.train.sinks import WandbSink

        sinks.append(WandbSink(project=args.wandb_project, name=run_id))
    trainer = Trainer(exp.trainer_cfg, exp.loss_fn, run_dir, eval_fns=exp.eval_fns,
                      sinks=sinks)
    state = trainer.fit(exp.model, exp.train_loader, exp.val_loaders, resume=args.resume,
                        constants=exp.constants)

    if args.test:
        # reference semantics: test on the EMA weights (src/train.py:100-118);
        # the fp32 rebuild and the held-out split live in _run_test_protocol
        params = {**state.model.state_dict(), **(state.ema_params or {})}
        fs_state = (state.constants or {}).get("first_stage")
        _run_test_protocol(args, exp, params, fs_state, run_dir, molecule)

    print(f"done: step={state.step} run_dir={run_dir}")
    return 0


def _run_test_protocol(args, exp, params, fs_state, run_dir, molecule):
    """The domain test protocol on restored or trained weights (stage 2
    only): mean-K ADE/FDE for md17 (second_stage/md17.py:139-171), the
    per-entity min over ``num_runs`` of K samples for pedestrian and nba
    (second_stage/pedestrian.py:149-239), with the final-position
    clustering where the config's ``post_process`` asks for it; for the
    peptide domain only a pointer to ``analysis.eval_cli``, and no metrics
    (lam_slide_tpu/train/cli.py:295-316).

    Reference precision and data semantics (src/train.py:100-118): the test
    pass runs with precision="32-true" on the held-out test split, here the
    fp32-rebuilt ``exp.test_model`` over ``exp.test_loaders``, loaded with
    the weights (``params``: the trained state dict with the EMA over its
    parameters) and the frozen first stage (``fs_state``), every floating
    tensor cast to fp32; K repeats one at a time (``k_chunk=1``), as JAX
    does."""
    from lam_slide_tpu_torch.composites import testing
    from lam_slide_tpu_torch.experiments.registry import MD17_SCALES
    from lam_slide_tpu_torch.utils.trees import tree_to_f32

    if exp.meta.get("stage") != 2:
        print("test protocols are defined for stage-2 experiments only")
        return
    if exp.meta.get("domain") == "peptide":
        print(f"use python -m lam_slide_tpu_torch.analysis.eval_cli --run "
              f"{os.path.basename(os.path.normpath(run_dir))} for the peptide eval pipeline")
        return
    model = exp.test_model if exp.test_model is not None else exp.second_stage
    loaders = exp.test_loaders if exp.test_loaders is not None else exp.val_loaders
    model.backbone.load_state_dict(tree_to_f32(params))
    if fs_state is not None:
        model.first_stage.load_state_dict(tree_to_f32(fs_state))
    cfg = exp.meta.get("config", {})
    k = int(cfg.get("K", 5))
    if args.smoke:
        k = min(k, 2)
    if exp.meta.get("domain") == "md17":
        metrics = testing.evaluate_md17(model, loaders, scale=MD17_SCALES[molecule], k=k,
                                        k_chunk=1)
    else:
        metrics = testing.evaluate_min_k(model, loaders, k=k,
                                         num_runs=min(int(cfg.get("num_runs", k)), k), k_chunk=1,
                                         post_process=bool(cfg.get("post_process", False)))
    with open(os.path.join(run_dir, "test_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics))


if __name__ == "__main__":
    sys.exit(main())
