"""Multi-rank dry run of the port's data-parallel paths on the CPU.

    python -m lam_slide_tpu_torch.tools.multichip_dryrun [--ranks 2]

Spawns N gloo ranks (``parallel.run_ranks``) and prints one line for each
check, as the JAX package's multichip dry run does:

* the data-parallel (DP) train step of the tiny MD17 second stage (the JAX
  dry run's config: 16 entities, latent 8, a depth-2 hidden-32 4-head
  class-conditional DiT, 12-frame windows) on a batch whose halves are
  ethanol (9 atoms) and toluene (15), so the ranks' masks differ; its loss
  against the one-rank step on the same batch;
* the FSDP2 step (parallel/fsdp.py) of the same model, its loss against
  the one-rank step, and the share of parameter bytes it shards;
* with N even, the tensor-parallel step (parallel/tp.py) of the same model
  on a data N/2 x model 2 mesh (at ``--ranks 8``, JAX's data 4 x model 2),
  its loss beside the DP step's: equal, as in JAX's MULTICHIP_r05.json;
* the peptide stage-2 smoke experiment's DP step against one rank;
* a sharded K=2 Euler-2 sample of the peptide smoke model (each rank its
  rows, gathered) against the one-rank sample;
* the same through dopri5 (its step controller's error norm over the
  global batch, so every rank takes the one-rank run's steps).

Every rank builds the same models from fixed seeds; the one-rank
references run on rank 0 on copies, without the process group.
"""

import argparse
import copy
import functools

import numpy as np
import torch

TINY_MOLECULES = ("ethanol", "toluene")
TINY_SPAN = 12


def tiny_md17_configs():
    """(first-stage config, second-stage config, loss weights) of the JAX
    multichip dry run (``__graft_entry__.py:99-125``)."""
    from lam_slide_tpu_torch.composites.md17 import MD17FirstStageConfig, MD17SecondStageConfig

    fs_cfg = MD17FirstStageConfig(num_entities=16, dim_input=32, dim_latent=8, dim_entity=32,
                                  num_latents=8, dim_head_cross=8, dim_head_latent=8,
                                  num_head_cross=2, dropout_query=0.0)
    cfg2 = MD17SecondStageConfig(in_dim=fs_cfg.dim_latent, depth=2, hidden_size=32,
                                 num_heads=4, cond_idx=(0, 4), class_conditional=True,
                                 vec_in_dim=16, checkpointing=False)
    loss_kw = dict(weight_pos_loss=0.25, weight_inter_dist_loss=0.25,
                   calc_additional_losses=True)
    return fs_cfg, cfg2, loss_kw


def tiny_md17_batch(rows_each: int = 2) -> dict:
    """A numpy stage-2 batch: ``rows_each`` ethanol windows, then as many
    toluene windows (unshuffled, no rotation), padded to 16 entities."""
    from lam_slide_tpu_torch.data.collate import pad_collate_temporal
    from lam_slide_tpu_torch.data.loader import Loader
    from lam_slide_tpu_torch.data.md17 import MD17Dataset

    parts = []
    for i, molecule in enumerate(TINY_MOLECULES):
        ds = MD17Dataset(molecule=molecule, mode="train", span=TINY_SPAN, first_stage=False,
                         num_entities=16, force_length=rows_each, rand_rotation=False,
                         synthetic_frames=1500)
        ds.cond_index = i
        loader = Loader(ds, rows_each, functools.partial(pad_collate_temporal, num_entities=16),
                        shuffle=False, drop_last=False)
        parts.append(next(iter(loader)))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def build_tiny_md17(device="cpu", seed: int = 0):
    """-> (second stage, loss_fn) of the tiny config, weights from ``seed``."""
    from lam_slide_tpu_torch.composites.md17 import build_md17_first_stage, build_md17_second_stage

    fs_cfg, cfg2, loss_kw = tiny_md17_configs()
    gen = torch.Generator().manual_seed(seed)
    fs = build_md17_first_stage(fs_cfg, device=device, generator=gen)
    ss = build_md17_second_stage(cfg2, fs, device=device, generator=gen)
    return ss, ss.make_loss(**loss_kw)


def _step(model, loss_fn, batch, mesh=None, fsdp=False, tp=False, lr=1e-3):
    """One train step -> (this rank's loss, grad norm, state)."""
    from lam_slide_tpu_torch.parallel import shard_batch, shard_train_state, shard_train_state_fsdp
    from lam_slide_tpu_torch.train import create_train_state, make_train_step
    from lam_slide_tpu_torch.train.optim import AdamW

    tx = AdamW(lambda count: lr, weight_decay=0.0)
    state = create_train_state(model, tx)
    if fsdp:
        state = shard_train_state_fsdp(state, mesh)
    if tp:
        state = shard_train_state(state, mesh)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    if mesh is not None:
        tb = shard_batch(tb, mesh, full_local=True)
    state, metrics = make_train_step(loss_fn, tx, mesh=mesh)(state, tb, 0)
    return metrics["loss"], metrics["grad_norm"], state


def _rank_mean(x: torch.Tensor) -> float:
    import torch.distributed as dist

    x = x.detach().clone()
    dist.all_reduce(x)
    return float(x) / dist.get_world_size()


def _sharded_sample(ss, batch, mesh, method_kwargs, seed: int):
    from lam_slide_tpu_torch.composites.testing import _gather, _on_device
    from lam_slide_tpu_torch.parallel.rows import use_rows

    sample_k = ss.make_k_sample_fn(k=2, sampling_method="ODE", sampling_kwargs=method_kwargs)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        if mesh is None:
            local, rows = {k: torch.as_tensor(v) for k, v in batch.items()}, None
        else:
            local, rows = _on_device(batch, "cpu", mesh, None)
        with use_rows(rows):
            pos = sample_k(local, generator=gen)["atom14_pos"]
    return _gather(pos.transpose(0, 1), rows).transpose(0, 1)


def dryrun_rank(rank: int, n: int) -> list:
    """The checks on one rank -> the lines rank 0 prints."""
    from lam_slide_tpu_torch.experiments.registry import peptide_second_stage
    from lam_slide_tpu_torch.parallel import MeshSpec, make_mesh, sharded_share

    torch.manual_seed(0)
    mesh = make_mesh(MeshSpec(data=n))
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    lines = []
    batch = tiny_md17_batch(rows_each=n)

    ss, loss_fn = build_tiny_md17()
    one = None
    if rank == 0:
        one = float(_step(copy.deepcopy(ss.backbone), loss_fn, batch)[0])
    loss, _, _ = _step(ss.backbone, loss_fn, batch, mesh)
    loss = _rank_mean(loss)
    assert np.isfinite(loss), f"non-finite DP loss {loss}"
    if rank == 0:
        assert abs(loss - one) <= 1e-5 * max(1.0, abs(one)), f"DP loss {loss} != 1-rank {one}"
        lines.append(f"multichip_dryrun({n}): ok — loss={loss:.4f} (1 rank {one:.4f}), "
                     f"mesh={mesh_shape}")

    ss_f, loss_fn_f = build_tiny_md17()
    loss_f, _, state_f = _step(ss_f.backbone, loss_fn_f, batch, mesh, fsdp=True)
    loss_f = _rank_mean(loss_f)
    share = sharded_share(state_f.model, n)
    assert share["share"] > 0.5, f"FSDP left {share} of the parameter bytes replicated"
    if rank == 0:
        assert abs(loss_f - one) <= 1e-5 * max(1.0, abs(one)), f"FSDP loss {loss_f} != {one}"
        lines.append(f"multichip_dryrun({n}): fsdp ok — loss={loss_f:.4f}, "
                     f"{share['sharded_bytes']}/{share['total_bytes']} param bytes sharded "
                     f"over data (JAX's rule: {share['jax_rule_share']:.3f} of them)")

    if n % 2 == 0:
        mesh_tp = make_mesh(MeshSpec(data=n // 2, model=2))
        ss_t, loss_fn_t = build_tiny_md17()
        loss_t, _, state_t = _step(ss_t.backbone, loss_fn_t, batch, mesh_tp, tp=True)
        loss_t = _rank_mean(loss_t)
        split = sum(".shards." in name for name, _ in state_t.model.named_parameters())
        assert split > 0, "tensor parallelism split no block"
        if rank == 0:
            assert abs(loss_t - one) <= 1e-5 * max(1.0, abs(one)), f"TP loss {loss_t} != {one}"
            lines.append(f"multichip_dryrun({n}): tp ok — loss={loss_t:.4f} (DP {loss:.4f}, "
                         f"1 rank {one:.4f}), mesh="
                         f"{dict(zip(mesh_tp.mesh_dim_names, mesh_tp.shape))}, {split} "
                         f"shard tensors a rank")

    exp = peptide_second_stage(smoke=True, device="cpu")
    pep = next(iter(exp.train_loader))
    reps = max(1, (2 * n) // len(pep["aatype"]))
    pep = {k: np.concatenate([v] * reps) for k, v in pep.items()}
    if rank == 0:
        one_p = float(_step(copy.deepcopy(exp.model), exp.loss_fn, pep)[0])
    loss_p, _, _ = _step(exp.model, exp.loss_fn, pep, mesh)
    loss_p = _rank_mean(loss_p)
    if rank == 0:
        assert abs(loss_p - one_p) <= 1e-5 * max(1.0, abs(one_p)), (loss_p, one_p)
        lines.append(f"multichip_dryrun({n}): peptide s2 ok — loss={loss_p:.4f} "
                     f"(== 1 rank {one_p:.4f})")

    for name, kw in (("K-repeat Euler", {"sampling_method": "euler", "num_steps": 2}),
                     ("dopri5 K-repeat", {"sampling_method": "dopri5", "atol": 1e-3,
                                          "rtol": 1e-2})):
        pos = _sharded_sample(exp.second_stage, pep, mesh, kw, seed=4)
        assert pos.shape[:2] == (2, len(pep["aatype"])) and bool(torch.isfinite(pos).all())
        if rank == 0:
            ref = _sharded_sample(exp.second_stage, pep, None, kw, seed=4)
            err = float((pos - ref).abs().max())
            lines.append(f"multichip_dryrun({n}): sharded {name} sampling ok — K=2 decoded "
                         f"atom14_pos {tuple(pos.shape)}, max |sharded - 1 rank| {err:.3g}")
    return lines


def main(argv=None) -> int:
    from lam_slide_tpu_torch.parallel import run_ranks

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=2)
    args = p.parse_args(argv)
    lines = run_ranks(dryrun_rank, args.ranks, args=(args.ranks,), timeout_s=600.0)[0]
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
