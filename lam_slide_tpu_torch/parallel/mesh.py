"""Process group, device mesh and batch sharding (counterpart of
``lam_slide_tpu/parallel/mesh.py``).

JAX runs one SPMD program over a ``("data", "model")`` mesh of devices and
lets XLA insert the collectives. The port runs one process a rank, the
PyTorch way: ``init_distributed`` starts the process group (NCCL on the
card, gloo on the CPU), ``make_mesh`` lays the ranks out as a
``DeviceMesh`` with the same axis names, and ``shard_batch`` hands each
rank its contiguous rows of the global batch, as
``jax.make_array_from_process_local_data`` assembles them. The data-parallel
train step (train/steps.py) and FSDP2 (parallel/fsdp.py) run over the
``data`` axis, tensor parallelism (parallel/tp.py) over the ``model`` axis.
Rank ``data_rank * model + model_rank`` sits at (data_rank, model_rank), so
the ranks of one model group are neighbours; the model ranks of one data
rank load, draw and step on the same rows.

``run_ranks`` spawns N ranks of a function on this host, each in a process
of its own joined by a ``file://`` rendezvous: the CLI's ``--devices N``,
the multichip dry run and the CPU tests use it.
"""

import datetime
import io
import multiprocessing
import os
import queue as _queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lam_slide_tpu_torch.parallel.rows import Rows

AXES = ("data", "model")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh description. axes: ('data',) or ('data', 'model')."""

    data: int = -1  # -1 → all remaining devices
    model: int = 1

    def shape(self, n_devices: int):
        model = max(self.model, 1)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices"
            )
        return data, model


def init_distributed(backend: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, init_method: Optional[str] = None,
                     timeout_s: float = 600.0) -> Tuple[int, int]:
    """Start the default process group -> (rank, world size); a no-op when
    one is running. ``backend`` is "nccl" (the card; the default) or "gloo"
    (the CPU). Without an explicit rendezvous (``rank``, ``world_size``,
    ``init_method`` such as ``file:///tmp/x`` or ``tcp://host:port``) it
    reads torchrun's environment: ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR`` / ``MASTER_PORT`` (under ``srun`` without torchrun,
    ``SLURM_PROCID`` / ``SLURM_NTASKS`` stand for the first two). Under NCCL
    each rank takes the card ``LOCAL_RANK`` (``SLURM_LOCALID``; else its
    rank modulo the cards it sees)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = backend or "nccl"
    env = os.environ
    if rank is None:
        raw = env.get("RANK", env.get("SLURM_PROCID"))
        rank = None if raw is None else int(raw)
    if world_size is None:
        raw = env.get("WORLD_SIZE", env.get("SLURM_NTASKS"))
        world_size = None if raw is None else int(raw)
    if rank is None or world_size is None:
        raise RuntimeError("init_distributed: no rendezvous: pass rank, world_size and "
                           "init_method, or launch under torchrun (RANK, WORLD_SIZE, "
                           "MASTER_ADDR, MASTER_PORT)")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: NCCL needs a CUDA card; pass backend='gloo' "
                               "for the CPU")
        local = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID",
                                                  rank % torch.cuda.device_count())))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world_size


def make_mesh(spec: Optional[MeshSpec] = None):
    """A ``DeviceMesh`` with axes ("data", "model") over every rank of the
    running process group, on the backend's devices (NCCL: "cuda", gloo:
    "cpu"); a model axis above 1 is tensor parallelism (parallel/tp.py)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    spec = spec or MeshSpec()
    data, model = spec.shape(dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def batch_sharding(mesh) -> tuple:
    """DTensor placements of a batch: axis 0 over ``data``, replicated over
    ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def data_group(mesh):
    return mesh.get_group("data")


def data_rank(mesh) -> int:
    return mesh.get_local_rank("data")


def data_size(mesh) -> int:
    return mesh.size(AXES.index("data"))


def model_group(mesh):
    return mesh.get_group("model")


def model_rank(mesh) -> int:
    return mesh.get_local_rank("model")


def model_size(mesh) -> int:
    return mesh.size(AXES.index("model"))


def broadcast_module(model: torch.nn.Module, mesh) -> None:
    """Copy rank 0's parameters and buffers to every rank of ``mesh``, in
    place (DDP's start), so the replicas, and the whole weights tensor
    parallelism then slices, begin equal."""
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            dist.broadcast(t.data, src=0)


class LocalBatch(dict):
    """This rank's rows of a global batch; ``rows`` places them in it (None
    when the whole batch is on every rank, replicated)."""

    rows: Optional[Rows] = None


def shard_batch(batch: Mapping[str, Any], mesh, full_local: bool = False) -> LocalBatch:
    """This rank's part of a batch for the data-parallel step.

    ``full_local=False``: ``batch`` is already this process's rows (a
    ``Loader`` with ``process_shard``: every rank holds an equal contiguous
    slice, rank r the r-th). ``full_local=True``: every rank holds the
    whole global batch (``Loader.full_batch_feed``, or any loader without a
    process shard) and keeps its contiguous rows; a batch the data axis
    does not divide stays whole on every rank (replicated), as JAX's test
    protocol runs such a batch. On a data axis of one rank the rows are
    the whole batch, and the step still runs its collectives over the
    one-rank group."""
    out = LocalBatch(batch)
    size, rank = data_size(mesh), data_rank(mesh)
    group = data_group(mesh)
    n = len(next(iter(batch.values())))
    if full_local:
        if n % size:
            return out
        local = n // size
        out = LocalBatch({k: v[rank * local:(rank + 1) * local] for k, v in batch.items()})
        out.rows = Rows(rank * local, local, n, group, size)
        return out
    out.rows = Rows(rank * n, n, n * size, group, size)
    return out


# ---------------------------------------------------------------------------
# N ranks on this host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world_size, init_method, backend, args, kwargs, results):
    try:
        if backend == "gloo":  # one thread a rank: N ranks share this host's cores
            torch.set_num_threads(1)
        if init_method is not None:
            init_distributed(backend, rank=rank, world_size=world_size, init_method=init_method)
        out = fn(rank, *args, **kwargs)
        # as bytes: tensors put on the queue as they are would travel as
        # shared-memory handles that die with this process
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except BaseException:  # report, then exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              kwargs: Optional[Dict[str, Any]] = None, backend: str = "gloo",
              timeout_s: float = 300.0, init: bool = True) -> list:
    """Run ``fn(rank, *args, **kwargs)`` in ``world_size`` spawned processes
    joined into one process group (gloo on the CPU, or NCCL with a card a
    rank) -> the ranks' return values in rank order (they must pickle).
    ``fn`` must be importable by name. ``init=False`` leaves the process
    group to ``fn`` (a torchrun-style launch). A rank that raises or dies,
    or a run past ``timeout_s``, ends every rank and raises here with what
    the ranks reported."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="lam_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous") if init else None
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init_method, backend, tuple(args),
                                   dict(kwargs or {}), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: Dict[int, Tuple[bool, Any]] = {}
        deadline = time.monotonic() + timeout_s
        failure = None
        try:
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                    got[rank] = (ok, out)
                    if not ok:
                        failure = f"rank {rank} raised:\n{out}"
                        break
                    continue
                except _queue.Empty:
                    pass
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None) and r not in got]
                if dead:
                    codes = [procs[r].exitcode for r in dead]
                    failure = f"rank(s) {dead} died (exit codes {codes})"
                    break
                if time.monotonic() > deadline:
                    failure = f"ranks did not finish in {timeout_s:.0f} s (done: {sorted(got)})"
                    break
        finally:
            for p in procs:
                if failure is None:
                    p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
        if failure is not None:
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, {world_size}): "
                               f"{failure}")
    return [torch.load(io.BytesIO(got[r][1]), weights_only=False) for r in range(world_size)]
