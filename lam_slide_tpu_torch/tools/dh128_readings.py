"""Read, on a CUDA card over several seeds, the errors behind the dh-128 fp32
limits of ``chip_smoke.py`` (phase 3's dh-128 rows, phase 14's 2 x 128 fp32
protocol, phase 15's 3 x 128 fp32 window) and ``tests/test_torch_port_cuda.py``:
the kernel path against the plain path with TF32 off.

* Every row of ``chip_smoke.DH128_SPECS`` (K1-fp32 at 64 < dh <= 128, the
  fp32 QK-norm + RoPE transform, K5-fp32) at each seed of ``SEEDS``
  (``chip_smoke.dh128_errors``; seed 0 is phase 3's own input): the error
  relative to max |out| and, where the row asks for it, the lse's absolute
  error.
* The fp32 test protocol (``chip_smoke.f32_protocol_pair``: K=5, Euler-10,
  ``k_chunk=1``) at ``num_heads=2`` on the first test batch of the
  registry's full-width MD17 stage 2 (random weights, phase 14's synthetic
  aspirin trajectory), at each seed: the ADE/FDE difference in fp32 ulps.
* One fp32 Euler-10 window of the 4AA test model at ``num_heads=3`` on the
  eval's batch of two peptides (``chip_smoke.peptide_window_errors``, the
  registry's random weights perturbed), at each seed.

Run from the repository root:

    python -m lam_slide_tpu_torch.tools.dh128_readings
"""

import os

import torch

import chip_smoke as cs
from lam_slide_tpu_torch.experiments import registry
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.utils.trees import tree_to_f32

SEEDS = range(0, 4)


def main() -> None:
    print(f"card: {cs.nvidia_smi()}")
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for spec in cs.DH128_SPECS:
        for seed in SEEDS:
            rel, lse_err, abs_err = cs.dh128_errors(dev, spec, seed)[:3]
            lse = "" if lse_err is None else f", lse abs err {lse_err:.3e}"
            print(f"{spec[0]} seed {seed}: rel err {rel:.3e} (abs {abs_err:.3e}){lse}")
            torch.cuda.empty_cache()

    run1 = registry.md17_first_stage(molecule="aspirin", synthetic_frames=cs.MD17_LOOP_FRAMES,
                                     device=dev)
    run2 = registry.md17_second_stage(first_stage=run1, molecule="aspirin",
                                      synthetic_frames=cs.MD17_LOOP_FRAMES,
                                      num_heads=cs.MD17_WIDE_HEADS, device=dev)
    ss = run2.test_model
    ss.backbone.load_state_dict(run2.model.state_dict())
    batch = next(iter(run2.test_loaders["aspirin"]))
    for seed in SEEDS:
        kern, plain = cs.f32_protocol_pair(ss, batch, seed)
        print(f"fp32 protocol {cs.MD17_WIDE_HEADS} x 128 seed {seed}: kernel {kern} plain "
              f"{plain}: {cs.protocol_ulps(kern, plain):.1f} fp32 ulps")
    del run1, run2, ss, batch
    torch.cuda.empty_cache()

    os.environ["LAM_SLIDE_NO_DATA_CACHE"] = "1"
    run1 = registry.peptide_first_stage(device=dev)
    run2 = registry.peptide_second_stage(first_stage=run1, synthetic_peptides=2,
                                         synthetic_frames=cs.PEP_S2_FRAMES,
                                         num_heads=cs.WIDE_HEADS, device=dev)
    ss = run2.test_model
    ss.backbone.load_state_dict(tree_to_f32(run2.model.state_dict()))
    ss.backbone.eval()
    window_batch = cs.peptide_window_batch(ss, run2.test_loaders["test"].dataset.trajectories)
    for seed in SEEDS:
        abs_err, rel, max_pos = cs.peptide_window_errors(ss, window_batch, seed)
        print(f"fp32 Euler-{cs.NUM_STEPS} window {cs.WIDE_HEADS} x 128 seed {seed}: max_abs_err "
              f"{abs_err:.3e} rel {rel:.3e} (max |pos| {max_pos:.3f})")


if __name__ == "__main__":
    main()
