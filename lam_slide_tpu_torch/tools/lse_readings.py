"""Read the lse errors of K1 and K5 against the plain log-sum-exp on a CUDA
card, over several input seeds per shape: the readings behind the lse
limits of ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``; and, on
the same inputs, the transform kernel of K5 (``qk_normrope``) against
``pre_transform``: its largest difference in bf16 ulps at the magnitude of
each element's (even, odd) pair and the share of elements that differ, the
readings behind the transform limits there.

The inputs follow the GPU test's recipe (q/k/v as head-major views of
packed bf16 buffers drawn from ``torch.randn``, QK-norm scales ``1 + 0.2 *
randn``, softmax scale 0.3); seed 10 is the GPU test's seed, so at its
shapes it is the GPU test's own input. Prints one line per shape and
seed. Run from the repository root:

    python -m lam_slide_tpu_torch.tools.lse_readings
"""

import subprocess

import torch

import chip_smoke as cs
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import flash_normrope as fnr

# (B, H, Nq, Nk, dh): the GPU test's three shapes, then the train shapes
SHAPES = [(2, 16, 1000, 1000, 24), (3, 3, 130, 257, 64), (2, 3, 300, 300, 128),
          (32, 16, 1000, 1000, 24), (32, 3, 1000, 1000, 128)]
SEEDS = range(10, 16)
SCALE = 0.3


def lse_errors(dev, b, h, nq, nk, dh, seed):
    """-> (K1 lse max abs error, K5 lse max abs error, the transform's
    largest pair-ulp difference, its differing share) on one seed's inputs."""
    g = torch.Generator().manual_seed(seed)
    qbuf = torch.randn(b, nq, h * dh, generator=g).to(dev, torch.bfloat16)
    kvbuf = torch.randn(b, nk, 2 * h * dh, generator=g).to(dev, torch.bfloat16)
    torch.randn(b, h, nq, dh, generator=g)  # the test's output gradient, unused here
    q = qbuf.view(b, nq, h, dh).transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in kvbuf.view(b, nk, 2, h, dh).unbind(2))
    _, lse = fa._forward(q, k, v, SCALE, with_lse=True)
    _, want = fa.reference_attention(q, k, v, SCALE, return_lse=True)
    qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(max(nq, nk), dh, device=dev)
    _, lse5 = fnr._forward(q, k, v, qs, ks, cos, sin, SCALE, with_lse=True)
    want_t = fnr.pre_transform(q, k, qs, ks, cos, sin)
    _, want5 = fa.reference_attention(*want_t, v, SCALE, return_lse=True)
    ulps = torch.cat([cs.pair_ulps(a, w).flatten()
                      for a, w in zip(fnr.qk_normrope(q, k, qs, ks, cos, sin), want_t)])
    return ((lse - want).abs().max().item(), (lse5 - want5).abs().max().item(),
            ulps.max().item(), (ulps > 0).double().mean().item())


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    for shape in SHAPES:
        for seed in SEEDS:
            k1, k5, worst, share = lse_errors(dev, *shape, seed)
            print(f"lse {list(shape)} seed {seed}: K1 {k1:.3e} K5 {k5:.3e}; transform max "
                  f"{worst:.3f} pair ulps, differing share {share:.3e}")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
