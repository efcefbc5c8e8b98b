"""Read the MD17 train-step grads of the kernel path against the plain path
on a CUDA card, at the point ``chip_smoke.py``'s phase 10 compares them:
each stage's own starting weights, before any step of that stage. These
readings set the phase's limits (``S1_GRAD_REL_TOL``, ``MD17_GRAD_REL_TOL``).

For each seed, stage 1 is built by the port's registry (fp32, B=256, the
synthetic trajectories chip_smoke uses) and its grads are taken on the first
train batch, then stage 2 on that untrained stage 1 (the bf16 DiT and the
fp32 aux decode) at B=2 on its first train batch, with fixed draws as phase
10 takes them. At seed 0 stage 1's point is phase 10's own; phase 10's
stage 2 sits on a stage 1 that its stage-1 checks have trained. Printed per
stage: the relative error of the global grad norm and the worst per-tensor
error, kernel path against plain, and with ``--controls`` the same two
numbers for other runs of the plain path against it:

* ``repeat``: the plain path again, as it is (the comparison's own floor);
* ``tf32``: fp32 matmuls in TF32 (stage 1, and stage 2's aux decode);
* ``P<bits>``: the plain attention's softmax weights rounded to ``bits``
  explicit mantissa bits before the PV product (7, a bf16 rounding, in
  stage 1's fp32 attention; 6 and 3 in stage 2's bf16 DiT attention, where
  the plain path rounds them to bf16's 7; its fp32 decode is left as it is).

A limit that a lower-precision control stays under cannot see that loss
of precision.

``--step-test`` reads instead, for each seed, the point of
tests/test_torch_port_cuda.py's ``test_md17_first_stage_step_on_the_card``:
stage 1 from the registry's default data, the first 16 rows of its first
train batch, after one train step, draws from seed + 1 (seed 0 is the
test's own point). The
tool uses only entry points every tree of the port has, so a comparison of
two trees runs it from each:

    cd <tree> && PYTHONPATH=. python <this file> [--seeds 0 1 2 3] [--controls] [--step-test]
"""

import argparse
import subprocess
import sys

import torch

from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.experiments import registry
from lam_slide_tpu_torch.nn.blocks import set_backend
from lam_slide_tpu_torch.ops import attention as attention_ops
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.train import create_train_state, make_train_step

FRAMES = 100_000  # chip_smoke's MD17_FRAMES
GRAD_BATCH = 2  # chip_smoke's GRAD_BATCH


def _global_norm(grads):
    return torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()


def _round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """fp32 ``x`` rounded to ``bits`` explicit mantissa bits (to nearest)."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def _coarse_attention(bits: int, dtype: torch.dtype, plain):
    """``reference_attention`` (``plain``) with the softmax weights rounded
    to ``bits`` mantissa bits in the forward (the backward passes through),
    on ``dtype`` operands; others go to ``plain`` as they are."""

    def attn(q, k, v, scale=None, return_lse=False, mask=None):
        if v.dtype != dtype:
            return plain(q, k, v, scale, return_lse=return_lse, mask=mask)
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits + fa.mask_to_bias(mask)[:, None, None, :]
        lse = torch.logsumexp(logits, dim=-1) if return_lse else None
        w = torch.softmax(logits, dim=-1)
        w = w + (_round_mantissa(w.detach(), bits) - w.detach())
        out = torch.matmul(w.to(v.dtype), v)
        return (out, lse) if return_lse else out

    return attn


class _Control:
    """The plain path for the span of a ``with``: as it is (``repeat``), in
    TF32 (``tf32``), or with ``P<bits>`` on the attention of ``dtype``
    operands."""

    def __init__(self, name: str, dtype: torch.dtype):
        self.name, self.dtype = name, dtype

    def __enter__(self):
        if self.name == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        elif self.name.startswith("P"):
            self.saved = fa.reference_attention, attention_ops.reference_attention
            fa.reference_attention = attention_ops.reference_attention = _coarse_attention(
                int(self.name[1:]), self.dtype, self.saved[0])

    def __exit__(self, *exc):
        if self.name == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        elif self.name.startswith("P"):
            fa.reference_attention, attention_ops.reference_attention = self.saved


def _stage_readings(label, model, modules, loss_fn, batch, seed, dev, controls, dtype, smi):
    def grads(backend):
        for m in modules:
            set_backend(m, backend)
        model.zero_grad(set_to_none=True)
        generator = torch.Generator(device=dev).manual_seed(seed + 1)
        loss_fn(model, batch, generator, True)[0].backward()
        out = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        for m in modules:
            set_backend(m, "auto")
        return out

    def reading(name, got, ref):
        norm = abs(_global_norm(got) - _global_norm(ref)) / _global_norm(ref)
        norm32 = [torch.stack([g.norm() for g in gs.values()]).norm().item() for gs in (got, ref)]
        worst, where = max(((got[n] - r).norm().item() / r.norm().item(), n)
                           for n, r in ref.items())
        print(f"{label} seed {seed} {name}: global norm rel err {norm:.3e} (of fp32 norms "
              f"{abs(norm32[0] - norm32[1]) / norm32[1]:.3e}), worst tensor rel err "
              f"{worst:.3e} at {where} | {smi}", flush=True)

    got = grads("auto")
    ref = grads("plain")
    reading("kernel path vs plain", got, ref)
    for name in controls:
        with _Control(name, dtype):
            got = grads("plain")
        reading(f"control {name} vs plain", got, ref)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--controls", action="store_true")
    parser.add_argument("--step-test", action="store_true")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for seed in args.seeds:
        if args.step_test:
            run = registry.md17_first_stage(seed=seed, device=dev)
            batch = {k: v[:16] for k, v in device_batch(next(iter(run.train_loader)), dev).items()}
            make_train_step(run.loss_fn, run.tx)(create_train_state(run.model, run.tx), batch, 0)
            _stage_readings("stage 1 B=16 after a step", run.model, [run.model], run.loss_fn,
                            batch, seed, dev, ["repeat"] if args.controls else [], torch.float32,
                            smi)
            del run
            continue
        run1 = registry.md17_first_stage(seed=seed, synthetic_frames=FRAMES, device=dev)
        batch1 = device_batch(next(iter(run1.train_loader)), dev)
        _stage_readings("stage 1", run1.model, [run1.model], run1.loss_fn, batch1, seed, dev,
                        ["repeat", "tf32", "P7"] if args.controls else [], torch.float32, smi)
        run2 = registry.md17_second_stage(first_stage=run1, seed=seed,
                                          synthetic_frames=FRAMES, device=dev)
        ss = run2.second_stage
        batch2 = device_batch(next(iter(run2.train_loader)), dev)
        grad_batch = {k: v[:GRAD_BATCH] for k, v in batch2.items()}
        controls2 = ["repeat", "tf32", "P6", "P3"] if args.controls else []
        _stage_readings("stage 2", run2.model, [ss.backbone, ss.first_stage], run2.loss_fn,
                        grad_batch, seed, dev, controls2, torch.bfloat16, smi)
        del run1, run2
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
