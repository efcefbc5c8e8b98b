"""Read the errors of the fp32 kernels K2-fp32, K7-fp32 and K9-fp32 against
their plain versions on a CUDA card, over several input seeds at the MD17
test pass's shapes (B=64, T=30, L=192, hidden 256, 16 heads x dh 16): the
readings behind the fp32 limits of ``chip_smoke.py`` and
``tests/test_torch_port_cuda.py``.

TF32 is off on the plain side, so both sides are exact fp32 up to the
order of the sums. The inputs follow ``chip_smoke.md17_f32_kernel_checks``
(seed ``SEEDS[0]`` is its own input): x and the transposed nn.Linear weight
views of the DiT for K2, the residual stream, the transposed temporal
output and chunks of one modulation tensor for K7, packed views of one qkv
buffer for K9. Prints one line per kernel and seed: the largest error
relative to max |out| (for K7 its y; its x_new must be bit-identical).
Then the fp32 test protocol itself (``chip_smoke.f32_protocol_pair``: K=5,
Euler-10, ``k_chunk=1``) on the first test batch of the registry's full-width
stage 2 (random weights, phase 14's synthetic aspirin trajectory), kernel
path against the plain path, for several noise seeds: the readings behind
phase 14's limit. Run from the repository root:

    python -m lam_slide_tpu_torch.tools.f32_readings
"""

import subprocess

import torch

import chip_smoke as cs
from lam_slide_tpu_torch.experiments import registry
from lam_slide_tpu_torch.ops import _build

SEEDS = range(20, 24)
PROTOCOL_SEEDS = range(0, 3)


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in SEEDS:
        for name, (got, want, exact) in cs.f32_kernel_outputs(dev, seed).items():
            print(f"{name} seed {seed}: rel err {cs.errors(got, want)[1]:.3e}"
                  + ("" if exact is None else f"; x_new bit-identical {exact}"))
        torch.cuda.empty_cache()
    run1 = registry.md17_first_stage(molecule="aspirin", synthetic_frames=cs.MD17_LOOP_FRAMES,
                                     device=dev)
    run2 = registry.md17_second_stage(first_stage=run1, molecule="aspirin",
                                      synthetic_frames=cs.MD17_LOOP_FRAMES, device=dev)
    ss = run2.test_model
    ss.backbone.load_state_dict(run2.model.state_dict())
    batch = next(iter(run2.test_loaders["aspirin"]))
    for seed in PROTOCOL_SEEDS:
        kern, plain = cs.f32_protocol_pair(ss, batch, seed)
        print(f"fp32 protocol seed {seed}: kernel {kern} plain {plain}: "
              f"{cs.protocol_ulps(kern, plain):.1f} fp32 ulps")


if __name__ == "__main__":
    main()
