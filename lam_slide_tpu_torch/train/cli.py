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
prints the pointer to ``analysis.eval_cli``, the 4AA eval pipeline).

Runs go on the CUDA card (``--device`` picks another device, such as
``cpu``). Data parallelism (parallel/): ``--multihost`` joins the process
group torchrun sets up (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``; NCCL on the card, gloo with ``--device cpu``) and feeds
each process its slice of every batch; ``--devices N`` spawns N ranks on
this host, the role of the JAX CLI's virtual devices (gloo ranks with
``--device cpu``; on the card, one rank a GPU, so N may not exceed the
GPUs found), each loading the whole batch and keeping its rows; ``--fsdp``
shards the parameters, EMA and AdamW moments with FSDP2, ``--model-axis
M`` lays the ranks out as data x M and splits the DiT blocks over each
model group of M ranks (tensor parallelism, parallel/tp.py: whole heads and
MLP slices a rank; the M ranks of a data rank train on the same rows), and
``--test-mesh`` shards the test protocols over the data axis. A single
process given one of these runs a one-rank group. Rank 0 registers the run,
logs and writes the checkpoints (whole tensors); ``--no-mesh`` keeps a
launch unsharded.
"""

import argparse
import contextlib
import json
import os
import secrets
import sys


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
                        help="single rank, no sharding, whatever the other flags say")
    parser.add_argument("--model-axis", type=int, default=1,
                        help="mesh model-axis size; > 1 splits the DiT blocks over that many "
                             "ranks (tensor parallelism, parallel/tp.py); with --devices N or "
                             "--multihost")
    parser.add_argument("--fsdp", action="store_true",
                        help="fully-sharded data parallelism (parallel/fsdp.py, FSDP2): "
                             "params, EMA and AdamW moments sharded over the data axis")
    parser.add_argument("--devices", type=int, default=None,
                        help="spawn N data-parallel ranks on this host (gloo with --device "
                             "cpu, else one rank a GPU)")
    parser.add_argument("--multihost", action="store_true",
                        help="join torchrun's process group (RANK, WORLD_SIZE, MASTER_ADDR, "
                             "MASTER_PORT); each process loads its slice of every batch")
    parser.add_argument("--test-mesh", action="store_true",
                        help="shard the --test protocols over the data axis (default: every "
                             "rank runs the whole protocol, the reference's single program)")
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

    argv = list(sys.argv[1:] if argv is None else argv)
    if args.devices and not args.no_mesh:
        return _spawn_devices(args, argv)
    with _process_group(args) as mesh:
        return _main(args, mesh)


def _spawn_devices(args, argv) -> int:
    """``--devices N``: run this command line in N ranks of one process
    group on this host, all with rank 0's run id."""
    import torch

    from lam_slide_tpu_torch.parallel.mesh import run_ranks

    n = args.devices
    if torch.device(args.device).type == "cuda":
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > found:
            raise SystemExit(f"--devices {n}: found {found} GPU(s); pass --device cpu for "
                             f"{n} gloo ranks on the CPU")
    i = argv.index("--devices")
    argv = argv[:i] + argv[i + 2:]
    if args.run_id is None:
        argv += ["--run-id", secrets.token_hex(4)]
    backend = "gloo" if torch.device(args.device).type == "cpu" else "nccl"
    codes = run_ranks(_rank_main, n, args=(argv,), backend=backend, timeout_s=24 * 3600.0)
    return max(codes)


def _rank_main(rank: int, argv) -> int:
    return main(argv)


@contextlib.contextmanager
def _process_group(args):
    """The data mesh of this launch (None without a multi-device flag or
    with --no-mesh): the running process group (a --devices rank,
    torchrun's under --multihost), or a one-rank group started here and
    ended on exit."""
    import tempfile

    import torch
    import torch.distributed as dist

    wants = (args.fsdp or args.multihost or args.test_mesh or args.devices
             or args.model_axis > 1 or dist.is_initialized())
    if args.no_mesh or not wants:
        yield None
        return

    from lam_slide_tpu_torch.parallel.mesh import MeshSpec, init_distributed, make_mesh

    backend = "gloo" if torch.device(args.device).type == "cpu" else "nccl"
    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory(prefix="lam_pg_") as tmp:
        if own and args.multihost:
            init_distributed(backend)
        elif own:
            init_distributed(backend, rank=0, world_size=1,
                             init_method="file://" + os.path.join(tmp, "rendezvous"))
        try:
            mesh = make_mesh(MeshSpec(model=args.model_axis))
            if args.multihost:
                from lam_slide_tpu_torch.data.loader import Loader
                from lam_slide_tpu_torch.parallel.mesh import data_rank, data_size

                # each data rank loads its slice; its model ranks the same one
                Loader.default_process_shard = (data_rank(mesh), data_size(mesh))
                print(f"multihost: process {dist.get_rank()}/{dist.get_world_size()}")
            if dist.get_rank() == 0:
                print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
            yield mesh
        finally:
            if args.multihost:
                from lam_slide_tpu_torch.data.loader import Loader

                Loader.default_process_shard = None
            if own:
                dist.destroy_process_group()


def _main(args, mesh) -> int:
    from lam_slide_tpu_torch.experiments.registry import build_experiment
    from lam_slide_tpu_torch.train.checkpoint import register_run, resolve_run
    from lam_slide_tpu_torch.train.trainer import Trainer

    main_rank = mesh is None or mesh.get_rank() == 0
    run_id = args.run_id or _shared_token(mesh)
    run_dir = os.path.join(args.workspace, run_id)
    if main_rank:
        print(f"run_id={run_id} device={args.device}"
              + ("" if mesh is None else f" ranks={mesh.size()}"))
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
    if args.fsdp:
        exp.trainer_cfg.fsdp = True
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
        _run_test_protocol(args, exp, params, fs_state, run_dir, molecule, mesh)
        if main_rank:
            print(f"done: test-only step={int(raw['step'])} run_dir={run_dir}")
        return 0

    if main_rank:
        register_run(args.workspace, run_id, run_dir, {
            **exp.meta,
            "launch": {
                "experiment": args.experiment, "molecule": molecule, "scene": scene,
                "smoke": bool(args.smoke), "data_root": args.data_root, "seed": args.seed,
                "first_stage_run": args.first_stage_run, "exp_overrides": exp_kwargs,
            },
        })
    sinks = []
    if main_rank and args.tensorboard:
        from lam_slide_tpu_torch.train.sinks import TensorBoardSink

        sinks.append(TensorBoardSink(os.path.join(run_dir, "tb")))
    if main_rank and args.wandb_project:
        from lam_slide_tpu_torch.train.sinks import WandbSink

        sinks.append(WandbSink(project=args.wandb_project, name=run_id))
    trainer = Trainer(exp.trainer_cfg, exp.loss_fn, run_dir, eval_fns=exp.eval_fns,
                      sinks=sinks, mesh=mesh)
    state = trainer.fit(exp.model, exp.train_loader, exp.val_loaders, resume=args.resume,
                        constants=exp.constants)

    if args.test:
        # reference semantics: test on the EMA weights (src/train.py:100-118);
        # the fp32 rebuild and the held-out split live in _run_test_protocol
        from lam_slide_tpu_torch.parallel.fsdp import full
        from lam_slide_tpu_torch.parallel.tp import gather_tree

        whole = gather_tree(state.model, {k: full(v) for k, v in {
            **state.model.state_dict(), **(state.ema_params or {})}.items()})
        fs_state = (state.constants or {}).get("first_stage")
        _run_test_protocol(args, exp, whole, fs_state, run_dir, molecule, mesh)

    if main_rank:
        print(f"done: step={state.step} run_dir={run_dir}")
    return 0


def _shared_token(mesh) -> str:
    """A fresh run id, rank 0's on every rank."""
    token = [secrets.token_hex(4)]
    if mesh is not None:
        import torch.distributed as dist

        dist.broadcast_object_list(token, src=0)
    return token[0]


def _run_test_protocol(args, exp, params, fs_state, run_dir, molecule, mesh=None):
    """The domain test protocol on restored or trained weights (stage 2
    only): mean-K ADE/FDE for md17 (second_stage/md17.py:139-171), the
    per-entity min over ``num_runs`` of K samples for pedestrian and nba
    (second_stage/pedestrian.py:149-239), with the final-position
    clustering where the config's ``post_process`` asks for it; for the
    peptide domain only a pointer to ``analysis.eval_cli``, and no metrics
    (lam_slide_tpu/train/cli.py:295-316). Over a mesh every rank runs the
    protocol, sharded over the data axis with ``--test-mesh``, and rank 0
    writes and prints the metrics.

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

    main_rank = mesh is None or mesh.get_rank() == 0
    if exp.meta.get("stage") != 2:
        print("test protocols are defined for stage-2 experiments only")
        return
    if exp.meta.get("domain") == "peptide":
        if main_rank:
            print(f"use python -m lam_slide_tpu_torch.analysis.eval_cli --run "
                  f"{os.path.basename(os.path.normpath(run_dir))} for the peptide eval "
                  f"pipeline")
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
    test_mesh = mesh if args.test_mesh else None
    if exp.meta.get("domain") == "md17":
        metrics = testing.evaluate_md17(model, loaders, scale=MD17_SCALES[molecule], k=k,
                                        k_chunk=1, mesh=test_mesh)
    else:
        metrics = testing.evaluate_min_k(model, loaders, k=k,
                                         num_runs=min(int(cfg.get("num_runs", k)), k), k_chunk=1,
                                         post_process=bool(cfg.get("post_process", False)),
                                         mesh=test_mesh)
    if not main_rank:
        return
    with open(os.path.join(run_dir, "test_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics))


if __name__ == "__main__":
    sys.exit(main())
