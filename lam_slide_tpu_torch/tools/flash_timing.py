"""Time flash-attention calls of the main paths on the card (CUDA events).

The MD17 protocol's fp32 K1 calls as ``evaluate_md17`` makes them, without
a gradient and so without the lse (K1-fp32 on the decoder's latent
self-attention [9600, 2, 192, 16], K1-bias on the encoder's masked
cross-attention [1920, 8, 192 -> 32, 16]), and the unmasked bf16 backward
kernels of the 4AA train step (K4 at [32, 16, 1000, 24], K6 at
[32, 3, 1000, 128], each from its forward's out and lse). It uses only
entry points every tree of the port has, so an A/B of two trees runs it
from each in turns:

    cd <tree> && PYTHONPATH=. python <this file> <label>

and prints one line per call with the card's name and power limit.
"""

import subprocess
import sys

import torch

from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import flash_normrope as fnr

REPS = 50


def _ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _heads(gen, dev, dtype, b, n, h, dh, scale=1.0):
    """q, k, v as head-major views of one packed buffer, and a head-major grad."""
    qkv = (torch.randn(b, n, 3, h, dh, generator=gen) * scale).to(dev, dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    return q, k, v, torch.randn(b, h, n, dh, generator=gen).to(dev, dtype)


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    q, k, v, _ = _heads(gen, dev, torch.float32, 9600, 192, 2, 16)
    cq = torch.randn(1920, 192, 8, 16, generator=gen).to(dev).transpose(1, 2)
    ck, cv = (t.transpose(1, 2) for t in torch.randn(1920, 32, 2, 8, 16, generator=gen)
              .to(dev).unbind(2))
    mask = (torch.arange(32)[None, :] < torch.randint(9, 22, (1920, 1), generator=gen)).to(dev)
    b4 = _heads(gen, dev, torch.bfloat16, 32, 1000, 16, 24)
    out4, lse4 = fa._forward(*b4[:3], 24 ** -0.5, with_lse=True)
    b6 = _heads(gen, dev, torch.bfloat16, 32, 1000, 3, 128, scale=2.0)
    qs, ks = ((1 + 0.2 * torch.randn(128, generator=gen)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(1000, 128, device=dev)
    nr = (qs, ks, cos, sin)
    out6, lse6 = fnr._forward(*b6[:3], *nr, 128 ** -0.5, with_lse=True)
    calls = (
        ("K1-fp32 [9600,2,192,16]", lambda: fa.flash_attention(q, k, v), REPS),
        ("K1-bias fp32 [1920,8,192->32,16]", lambda: fa.flash_attention(cq, ck, cv, mask=mask),
         REPS),
        ("K4 bf16 [32,16,1000,24]", lambda: fa.flash_attention_backward(
            *b4[:3], out4, lse4, b4[3], 24 ** -0.5), 10),
        ("K6 bf16 [32,3,1000,128]", lambda: fnr.flash_attention_normrope_backward(
            *b6[:3], *nr, out6, lse6, b6[3], 128 ** -0.5), 10),
    )
    with torch.no_grad():
        for name, fn, reps in calls:
            print(f"{label}: {name} {_ms(fn, reps):.4f} ms | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
