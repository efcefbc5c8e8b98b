"""Read, on a CUDA card over several seeds, the errors behind the limits of
``chip_smoke.py``'s pedestrian and NBA rows (phase 3) and of its phase 17
(the two workloads through the CLI): the kernel path against the plain
path, fp32 with TF32 off.

* ``chip_smoke.ped_nba_kernel_checks`` at each seed of ``SEEDS`` (K8, K9
  forward and backward, K2 and K7 at both workloads' shapes, bf16 and fp32):
  its rows print each error (its own limits apply).
* Stage 2's metrics and DiT grads at B=2 before any step
  (``chip_smoke.peptide_grad_errors``) on the registries' full-width runs
  (random weights, perturbed as phase 17 perturbs them), at each seed.
* The fp32 test protocol on the first ``chip_smoke.PN_CMP_ROWS`` windows of
  the first test batch (``chip_smoke.min_k_batch_errors``: K, num_runs and
  the final-position clustering of the config), at each seed.

Run from the repository root:

    python -m lam_slide_tpu_torch.tools.ped_nba_readings
"""

import torch

import chip_smoke as cs
from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.experiments import registry
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.utils.trees import tree_to_f32

SEEDS = range(0, 4)


def main() -> None:
    print(f"card: {cs.nvidia_smi()}")
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    for seed in SEEDS:
        print(f"-- pedestrian and NBA kernel rows, seed {seed}")
        cs.ped_nba_kernel_checks(dev, cs.KernelTable(), seed)
        torch.cuda.empty_cache()
    for workload in cs.PN_SHAPES:
        knob, n1, n2 = cs.PN_DATA[workload]
        run1 = registry.build_experiment(f"{workload}_first_stage", device=dev, **{knob: n1})
        run2 = registry.build_experiment(f"{workload}_second_stage", first_stage=run1,
                                         device=dev, **{knob: n2})
        batch = device_batch(next(iter(run2.train_loader)), dev)
        grad_batch = {k: v[:cs.GRAD_BATCH] for k, v in batch.items()}
        for seed in SEEDS:
            loss_err, norm_err, (worst, where), finite = cs.peptide_grad_errors(
                run2, grad_batch, seed)
            print(f"{workload} stage 2 grads seed {seed}: worst metric rel err {loss_err:.3e}, "
                  f"global norm rel err {norm_err:.3e}, worst tensor rel err {worst:.3e} at "
                  f"{where}, finite {finite}")
        ss = run2.test_model
        ss.backbone.load_state_dict(tree_to_f32(run2.model.state_dict()))
        rows = cs.PN_CMP_ROWS[workload]
        test_batch = {k: v[:rows] for k, v in device_batch(
            next(iter(next(iter(run2.test_loaders.values())))), dev).items()}
        for seed in SEEDS:
            got, want, rel, kern_s, plain_s = cs.min_k_batch_errors(ss, test_batch, run2.config,
                                                                  seed)
            print(f"{workload} fp32 protocol seed {seed} (B={rows}, K={run2.config.K}): "
                  f"largest rel difference {rel:.3e}; kernel {got} plain {want}; "
                  f"{kern_s:.3f} s / {plain_s:.3f} s")
        del run1, run2, ss
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
