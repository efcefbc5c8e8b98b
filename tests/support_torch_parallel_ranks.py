"""Rank-side checks of tests/test_torch_port_parallel.py.

Runs in each spawned gloo rank (``parallel.run_ranks``), so it imports
torch and the port only: the JAX side of every comparison runs in the
test process. ``parallel_checks`` reads the test's inputs (a torch.save
file), runs every multi-rank case and returns plain tensors and numbers.
"""

import contextlib
import io
import os

import torch
import torch.distributed as dist
from torch import nn


def cli_rank(rank: int, argv, env=None) -> dict:
    """``train.cli.main(argv)`` on this rank, with ``env`` set first (a
    torchrun-style rendezvous, the rank's own ``RANK``) -> its exit code
    and what it printed."""
    from lam_slide_tpu_torch.train.cli import main

    os.environ.update({k: str(v) for k, v in (env or {}).items()})
    if env is not None:
        os.environ["RANK"] = str(rank)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(list(argv))
    return {"code": code, "stdout": out.getvalue()}


def _full_params(model):
    from lam_slide_tpu_torch.parallel.fsdp import full, reshard, uses_fsdp

    if uses_fsdp(model):
        reshard(model)
    return {k: full(p).detach().clone() for k, p in model.named_parameters()}


def _full(tree):
    from lam_slide_tpu_torch.parallel.fsdp import full

    return {k: full(v).detach().clone() for k, v in tree.items()}


def _md17_step(inputs, mesh, fsdp: bool, inject: bool, grad_accum: int = 1):
    """One step of the tiny MD17 DiT from the JAX init on this rank's rows
    -> {loss (the ranks' mean), grad_norm, params, ema, share, the grad
    all-reduces of the step}."""
    from lam_slide_tpu_torch.train import steps
    from lam_slide_tpu_torch.parallel import rows as prow
    from lam_slide_tpu_torch.parallel import shard_batch, shard_train_state_fsdp, sharded_share
    from lam_slide_tpu_torch.tools.multichip_dryrun import build_tiny_md17
    from lam_slide_tpu_torch.train import create_train_state, make_train_step
    from lam_slide_tpu_torch.train.trainer import TrainerConfig, make_optimizer

    ss, loss_fn = build_tiny_md17()
    ss.first_stage.load_state_dict(inputs["fs_sd"])
    ss.backbone.load_state_dict(inputs["dit_sd"])
    transport = type(ss.transport)
    real = transport.sample
    if inject:
        t, x0 = inputs["t"], inputs["x0"]

        def sample(self, x1, generator):
            r = prow.active()
            sl = slice(None) if r is None else slice(r.offset, r.offset + r.count)
            return t[sl], x0[sl], x1

        transport.sample = sample
    try:
        tx, _ = make_optimizer(TrainerConfig(**inputs["trainer"]), 1)
        state = create_train_state(ss.backbone, tx)
        if fsdp:
            state = shard_train_state_fsdp(state, mesh)
        batch = shard_batch({k: torch.as_tensor(v) for k, v in inputs["batch"].items()}, mesh,
                            full_local=True)
        reduces = []
        real_reduce = steps.all_reduce_mean
        steps.all_reduce_mean = lambda *a: reduces.append(1) or real_reduce(*a)
        step = make_train_step(loss_fn, tx, mesh=mesh, grad_accum=grad_accum)
        state, metrics = step(state, batch, 0)
    finally:
        transport.sample = real
        steps.all_reduce_mean = real_reduce
    loss = metrics["loss"].detach().clone()
    dist.all_reduce(loss)
    out = {"loss": float(loss) / dist.get_world_size(), "local_loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]), "params": _full_params(state.model),
           "ema": _full(state.ema_params), "mask_sum": float(batch["attention_mask"].sum()),
           "grad_reduces": len(reduces)}
    if fsdp:
        out["share"] = sharded_share(state.model, dist.get_world_size())
    return out


class _CacheProbe(nn.Module):
    """A unit whose forward reads K8-fp32's kept weight operands of its own
    weights, as the outer-product kernel's wrapper does, and records
    whether they are those of the weights it runs with."""

    D, M, GROUP = 16, 32, 8

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w1 = nn.Parameter(torch.randn(3 * self.D + self.M, self.D, generator=g))
        self.w2 = nn.Parameter(torch.randn(self.D, self.D + self.M, generator=g))
        self.fresh = []

    def forward(self, x):
        from lam_slide_tpu_torch.ops import fused_spatial_block as fsb

        w1s, w2t = fsb._tiled_operands(self.w1, self.w2, self.D, self.M, self.GROUP, self.D)
        want = fsb._tiled_operands(self.w1.detach().clone(), self.w2.detach().clone(), self.D,
                                   self.M, self.GROUP, self.D)
        self.fresh.append(bool(torch.equal(w1s, want[0]) and torch.equal(w2t, want[1])))
        return (x @ self.w1.t()).sum() + (x @ self.w2[:, :self.D]).sum()


class _Root(nn.Module):
    def __init__(self):
        super().__init__()
        self.units = nn.ModuleList([_CacheProbe()])

    def forward(self, x):
        return self.units[0](x)


def _cache_trap(mesh):
    """FSDP2 all-gathers into the same parameters under a preserved version
    counter: the probe's kept operands must follow every step."""
    from lam_slide_tpu_torch.parallel import shard_model
    from lam_slide_tpu_torch.train.optim import AdamW

    root = shard_model(_Root(), mesh)
    x = torch.randn(4, _CacheProbe.D, generator=torch.Generator().manual_seed(1))
    tx = AdamW(lambda c: 0.1, 0.0)
    params = dict(root.named_parameters())
    opt = tx.init(params)
    for _ in range(2):
        root(x).backward()
        tx.step(params, {k: p.grad for k, p in params.items()}, opt, torch.tensor(1.0))
        for p in params.values():
            p.grad = None
    with torch.no_grad():
        root(x)
    return root.units[0].fresh


def _ring(inputs):
    from lam_slide_tpu_torch.parallel import sequence_parallel_attention

    out = {}
    for name, (q, k, v, g) in inputs["ring"].items():
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = sequence_parallel_attention(q, k, v)
        grads = torch.autograd.grad(o, (q, k, v), g)
        out[name] = (o.detach(), *grads)
    return out


def _sample(inputs, mesh):
    """The tiny model's K=2 Euler-10 sample of the batch, each rank its
    rows with its rows of the injected noise, gathered."""
    from lam_slide_tpu_torch.composites.testing import _gather, _on_device
    from lam_slide_tpu_torch.tools.multichip_dryrun import build_tiny_md17

    ss, _ = build_tiny_md17()
    ss.first_stage.load_state_dict(inputs["fs_sd"])
    ss.backbone.load_state_dict(inputs["dit_sd"])
    sample_k = ss.make_k_sample_fn(k=2, sampling_method="ODE",
                                   sampling_kwargs={"sampling_method": "euler", "num_steps": 10})
    local, rows = _on_device(inputs["batch"], "cpu", mesh, None)
    noise = inputs["noise"][:, rows.offset:rows.offset + rows.count]
    with torch.no_grad():
        pos = sample_k(local, noise=noise)["pos"]
    return _gather(pos.transpose(0, 1), rows).transpose(0, 1)


def parallel_checks(rank: int, path: str) -> dict:
    from lam_slide_tpu_torch.parallel import MeshSpec, make_mesh

    inputs = torch.load(path, weights_only=False)
    mesh = make_mesh(MeshSpec())
    out = {"cache_trap": _cache_trap(mesh), "ring": _ring(inputs),
           "sample": _sample(inputs, mesh)}
    for fsdp in (False, True):
        mode = "fsdp" if fsdp else "dp"
        for inject in (True, False):
            out[(mode, inject)] = _md17_step(inputs, mesh, fsdp, inject)
        out[(mode, "accum")] = _md17_step(inputs, mesh, fsdp, False, grad_accum=2)
    return out
