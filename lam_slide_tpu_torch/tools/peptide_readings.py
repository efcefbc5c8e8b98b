"""Read, on a CUDA card over several seeds, the errors behind the limits of
``chip_smoke.py``'s 4AA fp32 kernel rows (phase 3) and of its phase 15
(the 4AA workload): the kernel path against the plain path with TF32 off.

* ``chip_smoke.peptide_f32_kernel_checks`` at each seed of ``SEEDS``
  (K8-fp32 at [8000, 2, 384] and [2000, 2, 384] at both head splits,
  K3-fp32, K2-fp32 and K7-fp32 at the 4AA widths): its rows print each
  error relative to max |out| (its own limits apply).
* Stage 2's metrics and DiT grads at B=2 before any step
  (``chip_smoke.peptide_grad_errors``) on the registry's full-width runs
  (random weights, perturbed as phase 15 perturbs them), at each seed of
  ``SEEDS``.
* One fp32 Euler-10 window of the fp32 test model on the eval's batch of
  two peptides (``chip_smoke.peptide_window_errors``), at each seed.

Run from the repository root:

    python -m lam_slide_tpu_torch.tools.peptide_readings
"""

import os

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
        print(f"-- 4AA fp32 kernel rows, seed {seed}")
        cs.peptide_f32_kernel_checks(dev, torch.Generator().manual_seed(seed), cs.KernelTable())
        torch.cuda.empty_cache()
    os.environ["LAM_SLIDE_NO_DATA_CACHE"] = "1"
    run1 = registry.peptide_first_stage(device=dev)
    run2 = registry.peptide_second_stage(first_stage=run1, synthetic_peptides=2,
                                         synthetic_frames=cs.PEP_S2_FRAMES, device=dev)
    batch = device_batch(next(iter(run2.train_loader)), dev)
    grad_batch = {k: v[:cs.GRAD_BATCH] for k, v in batch.items()}
    for seed in SEEDS:
        loss_err, norm_err, (worst, where), finite = cs.peptide_grad_errors(run2, grad_batch, seed)
        print(f"stage 2 grads seed {seed}: worst metric rel err {loss_err:.3e}, global norm rel "
              f"err {norm_err:.3e}, worst tensor rel err {worst:.3e} at {where}, finite {finite}")
    ss = run2.test_model
    ss.backbone.load_state_dict(tree_to_f32(run2.model.state_dict()))
    ss.backbone.eval()
    window_batch = cs.peptide_window_batch(ss, run2.test_loaders["test"].dataset.trajectories)
    for seed in SEEDS:
        abs_err, rel, max_pos = cs.peptide_window_errors(ss, window_batch, seed)
        print(f"fp32 Euler-{cs.NUM_STEPS} window seed {seed}: max_abs_err {abs_err:.3e} rel "
              f"{rel:.3e} (max |pos| {max_pos:.3f})")


if __name__ == "__main__":
    main()
