"""Per-dataset sweep presets (reference configs/sweep/**, 19 YAMLs;
counterpart of ``lam_slide_tpu/experiments/sweeps.py``).

The reference's sweep group pins one dataset per entry (molecule / scene)
plus the frozen stage-1 wandb ``run_id`` it trains against
(e.g. configs/sweep/md17/aspirin.yaml). Here a sweep entry is
(experiment, overrides); the stage-1 lineage comes from the local run
registry instead of wandb, supplied per sweep via ``first_stage_runs``
(keyed by dataset name, or a single id shared across the sweep — the
reference's md17 sweeps share one stage-1 run the same way).

    from lam_slide_tpu_torch.experiments.sweeps import SWEEPS, run_sweep
    run_sweep("md17", workspace="runs", first_stage_runs="ab12cd34")

or from the shell:  python -m lam_slide_tpu_torch.experiments.sweeps md17 \
    --workspace runs --first-stage-run ab12cd34 [--smoke]

Runs train on one CUDA card (``device`` picks another, such as ``cpu``).
Multi-device runs (``devices``, SLURM jobs of more than one node) wait for
the port's ``parallel/`` and raise.
"""

from typing import Dict, List, Optional, Tuple, Union

PARALLEL_TODO = ("needs the port's parallel/, which is not ported yet (ROADMAP.md Queue 1, "
                 "the parallel/ item)")

# (experiment name, overrides) per dataset — mirrors the reference sweep tree:
# md17/{aspirin..uracil,all}, pedestrian/{eth,hotel,univ,zara1,zara2,all},
# nba/{score,rebound,score_16,all}, peptide 4AA.
SWEEPS: Dict[str, List[Tuple[str, Dict]]] = {
    "md17": [
        ("md17_second_stage", {"molecule": m})
        for m in ("aspirin", "benzene", "ethanol", "malonaldehyde",
                  "naphthalene", "salicylic", "toluene", "uracil")
    ],
    "md17_all": [("md17_second_stage", {"molecule": "all"})],
    "pedestrian": [
        ("pedestrian_second_stage", {"scene": s})
        for s in ("eth", "hotel", "univ", "zara1", "zara2")
    ],
    "nba": [
        ("nba_second_stage", {"scene": "score"}),
        ("nba_second_stage", {"scene": "rebound"}),
        # score_16: the reference's reduced-batch score variant
        ("nba_second_stage", {"scene": "score", "batch_size": 16}),
    ],
    "peptide": [("peptide_second_stage", {})],
}


def run_sweep(
    name: str,
    workspace: str = "runs",
    first_stage_runs: Optional[Union[str, Dict[str, str]]] = None,
    smoke: bool = False,
    extra: Optional[Dict] = None,
    jobs: int = 1,
    devices: Optional[int] = None,
    device: str = "cuda",
) -> List[str]:
    """Run every entry of sweep ``name`` -> list of run ids.

    jobs=1 (default) runs sequentially in-process, one run at a time on
    ``device``. jobs>1 recovers the reference's joblib/submitit multirun
    launcher (configs/hydra/joblib.yaml): each entry becomes a ``train.cli``
    subprocess with its own run workspace dir, up to ``jobs`` at a time
    (``device`` other than the card forwards ``--device``). ``devices``
    (the JAX launcher's virtual device mesh) raises.
    """
    if devices:
        raise NotImplementedError(f"run_sweep(devices={devices}) {PARALLEL_TODO}")
    if jobs > 1:
        return _run_sweep_parallel(name, workspace, first_stage_runs, smoke,
                                   extra, jobs, device)
    import os

    from lam_slide_tpu_torch.experiments.registry import EXPERIMENTS
    from lam_slide_tpu_torch.train.trainer import Trainer

    run_ids = []
    for exp_name, dataset, fs_run, kwargs, run_id in _resolve_entries(
            name, first_stage_runs, extra):
        exp = EXPERIMENTS[exp_name](
            smoke=smoke, workspace=workspace, first_stage_run=fs_run, device=device,
            **kwargs
        )
        run_dir = os.path.join(workspace, run_id)
        trainer = Trainer(exp.trainer_cfg, exp.loss_fn, run_dir,
                          eval_fns=exp.eval_fns)
        trainer.fit(exp.model, exp.train_loader, exp.val_loaders,
                    constants=exp.constants)
        print(f"sweep[{name}] {exp_name} {dataset}: run_id={run_id}")
        run_ids.append(run_id)
    return run_ids


def _resolve_entries(name, first_stage_runs, extra):
    """Shared entry resolution for both launchers: each sweep entry ->
    (exp_name, dataset, first_stage_run, builder kwargs, fresh run_id)."""
    import uuid

    for exp_name, overrides in SWEEPS[name]:
        kwargs = dict(overrides)
        dataset = kwargs.get("molecule") or kwargs.get("scene") or "all"
        fs_run = (first_stage_runs.get(dataset)
                  if isinstance(first_stage_runs, dict) else first_stage_runs)
        kwargs.update(extra or {})
        yield exp_name, dataset, fs_run, kwargs, uuid.uuid4().hex[:8]


def _run_sweep_parallel(name, workspace, first_stage_runs, smoke, extra,
                        jobs, device="cuda") -> List[str]:
    """Subprocess fan-out over sweep entries (the joblib-launcher shape).

    Each entry gets its own run_id/run_dir; the run registry handles
    concurrent registration via its file lock. Known experiment-builder
    keys map to CLI flags; anything else rides ``--exp-set``.
    """
    import concurrent.futures as cf
    import os
    import subprocess
    import sys

    entries = []
    for exp_name, dataset, fs_run, kwargs, run_id in _resolve_entries(
            name, first_stage_runs, extra):
        cmd = [sys.executable, "-m", "lam_slide_tpu_torch.train.cli",
               "--experiment", exp_name, "--workspace", workspace,
               "--run-id", run_id]
        if smoke:
            cmd.append("--smoke")
        if fs_run:
            cmd += ["--first-stage-run", str(fs_run)]
        if device != "cuda":
            cmd += ["--device", str(device)]
        for key, val in kwargs.items():
            if key in ("molecule", "scene"):
                cmd += [f"--{key}", str(val)]
            else:
                cmd += ["--exp-set", f"{key}={val}"]
        entries.append((run_id, exp_name, dataset, cmd))

    def launch(entry):
        run_id, exp_name, dataset, cmd = entry
        log_dir = os.path.join(workspace, run_id)
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "launcher.log"), "w") as log:
            proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT)
        ok = proc.returncode == 0
        print(f"sweep[{name}] {exp_name} {dataset}: run_id={run_id} "
              f"{'ok' if ok else f'FAILED rc={proc.returncode}'}", flush=True)
        return run_id if ok else None

    with cf.ThreadPoolExecutor(max_workers=jobs) as pool:
        results = list(pool.map(launch, entries))
    failed = results.count(None)
    if failed:
        raise RuntimeError(
            f"sweep[{name}]: {failed}/{len(entries)} jobs failed "
            f"(see <workspace>/<run_id>/launcher.log)")
    return [r for r in results if r]


def submit_slurm(name, workspace="runs", first_stage_runs=None, smoke=False,
                 extra=None, partition=None, account=None, time_limit="24:00:00",
                 nodes=1, qos=None, submit=True) -> List[str]:
    """Cluster-scale multirun launcher — the submitit-SLURM counterpart
    (reference configs/hydra/karolina.yaml, configs/hydra/meluxina.yaml:
    ``tasks_per_node: ${n_gpus}``, ``nodes: ${n_nodes}``, partition/account
    per cluster).

    One sbatch script per sweep entry under ``<workspace>/slurm/``, one
    ``srun`` task on one node, training on that node's card. ``nodes`` > 1
    (the JAX launcher's ``--multihost`` jobs) raises. ``submit=False`` (or no
    ``sbatch`` on PATH) writes the scripts and prints the submit commands
    instead — scheduling stays external, exactly like the reference's
    submitit integration.

    Returns the generated script paths.
    """
    if nodes > 1:
        raise NotImplementedError(f"submit_slurm(nodes={nodes}) {PARALLEL_TODO}")
    import os
    import shutil
    import subprocess
    import sys

    script_dir = os.path.join(workspace, "slurm")
    os.makedirs(script_dir, exist_ok=True)
    scripts = []
    for exp_name, dataset, fs_run, kwargs, run_id in _resolve_entries(
            name, first_stage_runs, extra):
        args = ["--experiment", exp_name, "--workspace", workspace,
                "--run-id", run_id]
        if smoke:
            args.append("--smoke")
        if fs_run:
            args += ["--first-stage-run", str(fs_run)]
        for key, val in kwargs.items():
            if key in ("molecule", "scene"):
                args += [f"--{key}", str(val)]
            else:
                args += ["--exp-set", f"{key}={val}"]
        directives = [
            f"#SBATCH --job-name=lam-slide-{name}-{dataset}-{run_id}",
            f"#SBATCH --nodes={nodes}",
            "#SBATCH --ntasks-per-node=1",  # one process per host
            f"#SBATCH --time={time_limit}",
            f"#SBATCH --output={os.path.abspath(workspace)}/{run_id}/slurm-%j.log",
        ]
        if partition:
            directives.append(f"#SBATCH --partition={partition}")
        if account:
            directives.append(f"#SBATCH --account={account}")
        if qos:
            directives.append(f"#SBATCH --qos={qos}")
        body = " ".join(["srun", sys.executable, "-m", "lam_slide_tpu_torch.train.cli",
                         *args])
        path = os.path.join(script_dir, f"{name}-{dataset}-{run_id}.sbatch")
        os.makedirs(os.path.join(workspace, run_id), exist_ok=True)
        with open(path, "w") as f:
            f.write("#!/bin/bash\n" + "\n".join(directives) + "\n\n"
                    "set -euo pipefail\nexport OMP_NUM_THREADS=1\n" + body + "\n")
        os.chmod(path, 0o755)
        scripts.append(path)

    sbatch = shutil.which("sbatch")
    for path in scripts:
        if submit and sbatch:
            out = subprocess.run([sbatch, path], capture_output=True, text=True)
            print(f"sbatch {path}: {(out.stdout or out.stderr).strip()}",
                  flush=True)
        else:
            print(f"generated {path} (submit with: sbatch {path})", flush=True)
    return scripts


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sweep", choices=sorted(SWEEPS))
    p.add_argument("--workspace", default="runs")
    p.add_argument("--first-stage-run", default=None)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--jobs", type=int, default=1,
                   help="parallel subprocess launches (joblib-launcher shape)")
    p.add_argument("--devices", type=int, default=None, help=PARALLEL_TODO)
    p.add_argument("--device", default="cuda",
                   help="torch device each run trains on (default: the card)")
    p.add_argument("--slurm", action="store_true",
                   help="emit/submit one sbatch script per entry instead of "
                        "running locally (the submitit-multirun counterpart)")
    p.add_argument("--slurm-partition", default=None)
    p.add_argument("--slurm-account", default=None)
    p.add_argument("--slurm-qos", default=None)
    p.add_argument("--slurm-time", default="24:00:00")
    p.add_argument("--slurm-nodes", type=int, default=1,
                   help=f"hosts per job; > 1 {PARALLEL_TODO}")
    p.add_argument("--no-submit", action="store_true",
                   help="with --slurm: only generate the scripts")
    args = p.parse_args(argv)
    if args.slurm:
        submit_slurm(args.sweep, workspace=args.workspace,
                     first_stage_runs=args.first_stage_run, smoke=args.smoke,
                     partition=args.slurm_partition, account=args.slurm_account,
                     qos=args.slurm_qos, time_limit=args.slurm_time,
                     nodes=args.slurm_nodes, submit=not args.no_submit)
        return
    run_sweep(args.sweep, workspace=args.workspace,
              first_stage_runs=args.first_stage_run, smoke=args.smoke,
              jobs=args.jobs, devices=args.devices, device=args.device)


if __name__ == "__main__":
    main()
