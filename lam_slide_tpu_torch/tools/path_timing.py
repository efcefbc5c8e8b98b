"""Time the kernel path of the port's main paths on a CUDA card, for an A/B of
two trees of the port in turns (parent, change, change, parent: one process
each, in one call on one card).

The paths and their settings are ``chip_smoke.py``'s, read from the tree the
tool runs in (its constants and helpers), so each tree times its own
configuration:

* the 4AA Euler-10 solve at B=8 (the whole solve), at 16 x dh 24 and at
  3 x dh 128;
* the 4AA train step at B=16 (AdamW, EMA), at 16 x dh 24 and at 3 x dh 128;
* one MD17 protocol batch (K=5 Euler-10 samples of 64 aspirin windows,
  decoded by stage 1, and their ADE/FDE), and the MD17 stage-2 train step
  at B=64, both on the registry's random weights and synthetic
  trajectories.

With ``--fp32`` it times the 4AA DiT in fp32 instead (TF32 off), the
kernel path and the plain path: the Euler-10 window at the eval's B=2 and
the train step at B=16, at 16 x dh 24 and at 3 x dh 128. With
``--md17-fp32`` it times MD17's fp32 DiT at 16 x dh 16 (TF32 off), kernel
path: the fp32 stage-2 train step at B=64 (phase 16's, checkpointed) and
one protocol batch of its fp32 DiT as the ``--test`` pass runs it (K=5,
k_chunk=1, B=64, a val batch), where K9-fp32 runs 8 times a step forward
and 4 backward, and 180 times a batch.

Each is warmed up once and then timed ``--runs`` times with the card
synchronised around it; printed are the mean and the runs in ms, with the
card's name and power limit. Run it from a tree's root:

    cd <tree> && PYTHONPATH=. python <this file> [--runs 3] [--label parent] \
        [--fp32 | --md17-fp32]
"""

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from lam_slide_tpu_torch.composites.evaluation import mean_over_k_ade_fde, zero_target_frames
from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.train import create_train_state, make_train_step
from lam_slide_tpu_torch.transport import Sampler, create_transport


def _timed(fn, runs: int) -> list:
    fn()  # warm-up
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _fp32_paths(runs: int, dev, make_model, euler, report) -> None:
    """The 4AA DiT in fp32 (TF32 off), kernel path and plain path: the
    Euler-10 window at B=2 and the B=16 train step, at both head splits."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for heads in (cs.HEADS, cs.WIDE_HEADS):
        split = f"{heads}x{cs.HIDDEN // heads}"
        for backend in ("auto", "plain"):
            path = "kernel" if backend == "auto" else "plain"
            with torch.no_grad():
                model = make_model(heads, torch.float32, backend)
                noise, x_cond, mask = cs.make_inputs(2, dev,
                                                     torch.Generator().manual_seed(cs.SEED))
                report(f"4AA fp32 Euler-{cs.NUM_STEPS} {split} B=2 window, {path} path",
                       _timed(lambda: euler(noise, model, x_cond=x_cond, x_cond_mask=mask),
                              runs))
                del model
            state, step, transport = cs.train_state(
                lambda h, backend: make_model(h, torch.float32, backend), heads, backend)
            batch = cs.train_batch(cs.TRAIN_BATCH, dev, transport, False, cs.SEED)
            holder = {"state": state}

            def train_step():
                holder["state"], _ = step(holder["state"], batch, cs.SEED)

            report(f"4AA fp32 {split} B={cs.TRAIN_BATCH} train step, {path} path",
                   _timed(train_step, runs))
            del state, holder, batch
            torch.cuda.empty_cache()


def _md17_fp32_paths(runs: int, dev, report) -> None:
    """MD17's fp32 DiT at 16 x dh 16 (TF32 off), kernel path: the stage-2
    train step at B=64 on phase 16's data and one fp32 protocol batch."""
    from lam_slide_tpu_torch.composites import testing
    from lam_slide_tpu_torch.experiments import registry

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    run1 = registry.md17_first_stage(seed=cs.SEED, molecule="aspirin",
                                     synthetic_frames=cs.F32_MD17_FRAMES, device=dev)
    run2 = registry.md17_second_stage(first_stage=run1, seed=cs.SEED, molecule="aspirin",
                                      synthetic_frames=cs.F32_MD17_FRAMES, dit_dtype="float32",
                                      num_heads=16, device=dev)
    batch = device_batch(next(iter(run2.train_loader)), dev)
    step = make_train_step(run2.loss_fn, run2.tx, ema_decay=run2.trainer_cfg.ema_decay)
    holder = {"state": create_train_state(run2.model, run2.tx)}

    def train_step():
        holder["state"], _ = step(holder["state"], batch, cs.SEED)

    report(f"MD17 fp32 16x16 stage-2 B={cs.MD17_BATCH} train step", _timed(train_step, runs))
    val = next(iter(run2.val_loaders["aspirin"]))
    with torch.no_grad():
        report(f"MD17 fp32 16x16 protocol batch K={cs.MD17_K} B={cs.MD17_BATCH} k_chunk=1",
               _timed(lambda: testing.evaluate_md17(run2.second_stage, {"md17": [val]},
                                                    scale=1.0, k=cs.MD17_K, k_chunk=1), runs))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--label", default="tree")
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--md17-fp32", action="store_true")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    def report(path, times):
        print(f"path_timing {args.label} {path}: mean {np.mean(times):.3f} ms, runs "
              f"{[round(t, 3) for t in times]} ms | {smi}", flush=True)

    def make_model(heads, dtype=torch.bfloat16, backend="auto"):
        return LatentDiT(depth=cs.DEPTH, in_dim=cs.DIN, hidden_size=cs.HIDDEN, num_heads=heads,
                         mlp_ratio=cs.MLP_RATIO, reference_init=False, dtype=dtype,
                         backend=backend, device=dev,
                         generator=torch.Generator().manual_seed(cs.SEED)).eval()

    euler = Sampler(create_transport(path_type="GVP", prediction="data")).sample_ode(
        sampling_method="euler", num_steps=cs.NUM_STEPS)
    if args.fp32:
        _fp32_paths(args.runs, dev, make_model, euler, report)
        return 0
    if args.md17_fp32:
        _md17_fp32_paths(args.runs, dev, report)
        return 0
    for heads in (cs.HEADS, cs.WIDE_HEADS):
        split = f"{heads}x{cs.HIDDEN // heads}"
        with torch.no_grad():
            model = make_model(heads)
            noise, x_cond, mask = cs.make_inputs(8, dev, torch.Generator().manual_seed(cs.SEED))
            report(f"4AA Euler-{cs.NUM_STEPS} {split} B=8 solve",
                   _timed(lambda: euler(noise, model, x_cond=x_cond, x_cond_mask=mask),
                          args.runs))
            del model

        state, step, transport = cs.train_state(make_model, heads)
        batch = cs.train_batch(cs.TRAIN_BATCH, dev, transport, False, cs.SEED)
        holder = {"state": state}

        def train_step():
            holder["state"], _ = step(holder["state"], batch, cs.SEED)

        report(f"4AA {split} B={cs.TRAIN_BATCH} train step", _timed(train_step, args.runs))
        del state, holder, batch
        torch.cuda.empty_cache()

    run1 = cs.md17_first_run(dev)
    run2 = cs.md17_second_run(run1, dev)
    ss = run2.second_stage
    val = device_batch(next(iter(run2.val_loaders["aspirin"])), dev)
    cond_end = ss.cond_idx[1]
    zeroed = zero_target_frames(val, cond_end)
    true_pos, mask = val["pos"][:, cond_end:], val["attention_mask"][:, cond_end:]
    noise = torch.randn((cs.MD17_K, cs.MD17_BATCH, cs.MD17_T, run1.config.num_latents,
                         run1.config.dim_latent), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(cs.SEED + 2))
    sample_k = ss.make_k_sample_fn(cs.MD17_K, sampling_kwargs={"sampling_method": "euler",
                                                                "num_steps": cs.NUM_STEPS})

    def protocol_batch():
        preds = sample_k(zeroed, noise=noise)
        return mean_over_k_ade_fde(preds["pos"][:, :, cond_end:], true_pos, mask)

    with torch.no_grad():
        report(f"MD17 protocol batch K={cs.MD17_K} B={cs.MD17_BATCH}",
               _timed(protocol_batch, args.runs))

    batch2 = device_batch(next(iter(run2.train_loader)), dev)
    step2 = make_train_step(run2.loss_fn, run2.tx, ema_decay=run2.trainer_cfg.ema_decay)
    holder = {"state": create_train_state(run2.model, run2.tx)}

    def md17_step():
        holder["state"], _ = step2(holder["state"], batch2, cs.SEED)

    report(f"MD17 stage-2 B={cs.MD17_BATCH} train step", _timed(md17_step, args.runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
