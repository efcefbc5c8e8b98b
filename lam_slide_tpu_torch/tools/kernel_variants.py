"""Time ablated copies of K9's backward and K11 on the card: what holds each back.

Each variant is a copy of the kernel's source with one piece of its work
taken out by a text substitution, built alone with nvcc (beside
csrc/common.cu) into its own library under ``lam_slide_tpu_torch/_build/``
and called through ctypes on the same inputs at the MD17 shapes: K9's
backward on packed [61440, 30, 256] (16 heads of 16, v a view of a wider
buffer) and K11 on head-major views [1920, 16, 192, 16] with K1's out and
lse. A variant's outputs are wrong by design; only its time means anything.
The variants run in turns (in order, then in reverse), timed with CUDA
events, beside PyTorch's fp32 rowsum(g * out) at K11's shape (the delta the
K11 wrapper computed before its delta kernel). Each line names the card and
its power limit. Run from a tree's root:

    PYTHONPATH=. python lam_slide_tpu_torch/tools/kernel_variants.py
"""

import ctypes
import subprocess
import sys

import torch

from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import short_attention as tsa

REPS = 20
# variant: [(text in the source, its replacement), ...]
K11_VARIANTS = {
    "kernel": [],
    "no dK/dV stores": [("    write_rows<DV>(dk,", "    if (false) write_rows<DV>(dk,"),
                        ("    write_rows<DV>(dv,", "    if (false) write_rows<DV>(dv,")],
    "no exponential": [("const float p = ex2(fmaf(s[i], c, -(lse[col] * LOG2E)));",
                        "const float p = s[i];")],
    "no dQ": [("if (qc % NW == wg) {", "if (false) {")],
    "no chunk barrier": [("named_sync(1, consumers);  // the slab", "// the slab")],
    "no dK/dV products": [("wgmma_rs<DV, 1>(dv, pf[kk]", "if (false) wgmma_rs<DV, 1>(dv, pf[kk]"),
                          ("wgmma_rs<DV, 1>(dk, df[kk]", "if (false) wgmma_rs<DV, 1>(dk, df[kk]")],
}
K9_VARIANTS = {
    "kernel": [],
    "loads and stores only": [("    if (h0 + warp < a.H) {\n", "    if (false) {\n")],
    "math and stores only": [
        ("  if (t < items) load_item<DP>(a, smem, t);", ""),
        ("    if (t + gridDim.x < items) load_item<DP>(a, smem + ((j & 1) ^ 1) * 4 * te, "
         "t + gridDim.x);", "")],
}


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


def _build_variants(source: str, entry: str, variants: dict) -> dict:
    """{variant: the ctypes entry of its library}, built in parallel."""
    text = (_build.CSRC / source).read_text()
    out = _build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{source}: variant {name!r} finds no {old!r}")
            src = src.replace(old, new)
        tag = f"{source.split('.')[0]}_{''.join(c if c.isalnum() else '_' for c in name)}"
        (out / f"{tag}.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}", "-o",
               str(out / f"lib{tag}.so"), str(out / f"{tag}.cu"), str(_build.CSRC / "common.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out / f"lib{tag}.so")
    entries = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} variant {name!r}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = _build.SIGNATURES[entry], ctypes.c_int
        entries[name] = fn
    return entries


def _checked(fn, args):
    """A call of a ctypes entry that raises on a CUDA error code."""
    def call():
        code = fn(*args)
        if code:
            raise RuntimeError(f"{fn.__name__}: CUDA error {code}")
    return call


def _in_turns(label: str, calls: dict, smi: str) -> None:
    for name in (*calls, *reversed(list(calls))):
        print(f"{label} {name}: {_ms(calls[name]):.4f} ms | {smi}", flush=True)


def main() -> int:
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    k11 = _build_variants("short_backward.cu", "lam_short_backward", K11_VARIANTS)
    k9 = _build_variants("short_attention.cu", "lam_short_attention_bwd", K9_VARIANTS)
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream

    qkv = torch.randn(1920, 192, 3, 16, 16, generator=gen).to(dev, bf)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    g = torch.randn(1920, 16, 192, 16, generator=gen).to(dev, bf)
    out, lse = fa._forward(q, k, v, 0.25, with_lse=True)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=dev)
    grads = [torch.empty(t.shape, dtype=bf, device=dev) for t in (q, k, v)]
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, g, *grads) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in grads), 1920, 16, 192,
            192, 16, strides, 0.25, int(fa.sm90_tma_ok(q, k, v, g)), stream)
    calls = {name: _checked(fn, args) for name, fn in k11.items()}
    calls["PyTorch delta"] = lambda: (g.float() * out.float()).sum(dim=-1).contiguous()
    _in_turns("K11 [1920,16,192,16]", calls, smi)
    del qkv, q, k, v, g, out, lse, delta, grads

    b = 61440
    q, k, g = (torch.randn(b, 30, 256, generator=gen).to(dev, bf) for _ in range(3))
    v = torch.randn(b, 30, 768, generator=gen).to(dev, bf)[..., 512:]
    grads = [torch.empty(b, 30, 256, dtype=bf, device=dev) for _ in range(3)]
    strides9 = (ctypes.c_longlong * 8)(*(s for t in (q, k, v, g) for s in t.stride()[:2]))
    args9 = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             *(t.data_ptr() for t in grads), b, 16, 30, 16, tsa.bwd_heads_per_block(30, 16, 16),
             strides9, grads[0].stride(0), grads[0].stride(1), 0.25, stream)
    _in_turns(f"K9 backward [{b},30,256]", {name: _checked(fn, args9) for name, fn in k9.items()},
              smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
