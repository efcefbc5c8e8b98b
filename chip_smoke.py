#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

The main paths are the 4AA stage-2 sampler, the 4AA stage-2 train step, the
MD17 sampling protocol, the MD17 training of both stages, the paths of the
two ablation kernels (K10, K11), the SDE and likelihood samplers, MD17
end to end through the port's own loop (its CLI, Trainer, checkpoints and
run registry) to the fp32 test pass, the pedestrian and NBA workloads
through the same loop to their fp32 min-over-K test pass, raw MD
trajectory files through the port's preprocessing into the 4AA loop, and
the port's parallel/ (the data-parallel and FSDP2 train steps on a
one-rank NCCL group, ring attention over chunks on the card, the sampling
hook). The
4AA paths run the full-width ``LatentDiT`` (depth 7, hidden 384,
mlp_ratio 2, T=1000 frames, L=2 latents, in_dim 96, bf16) with random
weights drawn from a seed, at both head splits (16 heads x dh 24 and 3
heads x dh 128). The sampler is the GVP
data-prediction probability-flow ODE with both samplers (Euler,
num_steps=10, and the eval protocol's dopri5 at atol 1e-6 / rtol 1e-3);
the train step is the SI loss at the registry's B=16 with AdamW (lr
1e-3, weight decay 0.01), global-norm clip 0.5 and EMA 0.999. Phases, each
printed on its own line with its seconds:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit from nvidia-smi;
2. build: compiles ``lam_slide_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   one process per source, and the native host engine
   (``lam_slide_tpu_torch/native/*.cc``) with g++;
3. kernels: each kernel (K1 flash, K2 fused MLP, K3 packed flash, K5 flash
   with QKNorm + RoPE and its transform kernel, K7 residual AdaLN, K8
   spatial block) against its plain PyTorch version at main-path shapes at
   B=2 and B=8 in bf16, then the backward kernels K4 (flash) and K6 (flash
   with QKNorm + RoPE) and the lse outputs of K1 and K5 at the train shapes
   and a ragged one, and the MD17 kernels (below), with the tolerance stated
   beside each check, its time, the plain version's time, its bound and,
   where one PyTorch call computes the same function, that call's time;
4. slice: Euler-10 solves at 16x24 (B=2, B=8) and 3x128 (B=8) and one
   dopri5 solve (16x24, B=8) through the kernels, checking shapes,
   finiteness and the launches of every kernel per solve, and one model
   forward per split against the plain path on the same weights, in bf16
   and in float32;
5. timing: solve times of the kernel path and the plain path, and the
   dopri5 drift evaluations per second;
6. profile: one solve per path and batch under ``torch.profiler``: device
   kernel time, the device's idle share, launches and the costliest kernels;
7. train: one train step per split at B=16 through the kernels with the
   launches of every kernel per step; every parameter's grad finite and
   non-zero; at B=2 the kernel path's grads against the plain path's in
   bf16 and a float32 plain copy; ten steps on one fixed batch, in which
   the SI loss falls and the EMA moves;
8. train timing: train-step time (median of 5 after warm-up), samples/s and
   peak memory at B=16 of the kernel path and the plain path (at 16 x 24
   also with per-layer checkpointing), and one profiled step per split;
9. md17: the MD17 K-repeat protocol (``evaluate_md17``, K=5, Euler-10, at
   the loaders' B=64) on both stages built by the port's registry at full
   width: the fp32 stage 1 (192 latents of 32, cross-attention 8 x dh 16
   over 32 padded atoms, latent attention 2 x dh 16) and the bf16
   class-conditional DiT (depth 4, hidden 256, 16 x dh 16, T=30, L=192),
   random weights from the seed and a batch from the ported loader
   (synthetic trajectories). It checks the launches of K1 (bias, fp32,
   bf16), K2, K3, K7 and K9 per protocol batch, finite ADE/FDE, and the
   decoded positions of the kernel path against the plain path on the same
   weights and noise; times one protocol batch on both paths and profiles
   it;
10. md17_train: both MD17 training experiments of the registry at full
   width on batches of the ported loader: stage 1 (fp32, B=256, AdamW lr
   4e-4, dropout from the step's generator), then stage 2 on it (the bf16
   DiT, B=64, per-layer checkpointing, the SI loss plus the aux position
   and inter-distance losses through the frozen stage 1, lr 1e-3, EMA
   0.999). For each stage: every grad finite and non-zero, grads of the
   kernel path against the plain path on the same draws at the stage's
   starting weights (stage 2 at B=2), the launches of every kernel per
   step (derived from the code, checkpointed recompute included), ten
   steps on one batch in which the loss (and stage 2's SI loss) falls and
   every metric stays finite, step times and peak memory of both paths, a
   profiled step; then ten stage-2 steps on the aux losses alone, in which
   their sum falls, and one call of the sampled val hook on the EMA
   weights.

11. ablation: the paths of the two kernels the JAX package keeps as opt-in
   ablations, through their entry points: the 4AA temporal block
   ``ParallelMLPAttention(hidden 384, 3 heads, fused_temporal=True)`` on x
   [16, 1000, 384] bf16 (K10 1 and K2 1 a forward, no K5; forward and grads
   against the plain path; its time against the same block on the K5
   route), and ``flash_backward_short`` (K11) at the MD17 stage-2 spatial
   axis [1920, 16, 192, 16] bf16;
12. samplers: one ``get_sample_fn("SDE")`` solve (250 Euler-Maruyama steps,
   the linear diffusion, the Mean last step) and one
   ``sample_ode_likelihood`` solve (50 Euler steps, a drift VJP through K4
   per step) on the 16 x 24 DiT at B=8: launches of every kernel per solve,
   finite outputs, solve times; kernel path against plain at B=2;
13. dit_variants: one forward each of the DiT with
   ``attention_mode="linear"``, with ``share_weights=True`` and at the tiny
   test registries' width (hidden 32, 4 x dh 8, whose spatial blocks take
   K8's WMMA route) against the plain path, with their launches;
14. md17_loop: the port's CLI (``train.cli.main``) in-process in a
   temporary workspace at full width on a synthetic aspirin trajectory:
   stage 1 (fp32, B=256, one epoch with val), then stage 2 read from the run
   registry (bf16 DiT, B=64, one epoch, val over one batch, the K=5 val hook,
   the checkpoint) with ``--test`` (the fp32 rebuild of the DiT over the
   test split, K=5 one repeat at a time), then ``--test-only`` from the
   checkpoint: every call returns 0, the metric streams are finite and
   complete, runs.json links the stages, ``--test-only`` reproduces
   ``--test`` exactly, the test pass launches the fp32 K1, K2, K7 and K9 and
   no bf16 DiT kernel while training launches the bf16 ones and K4; the fp32
   protocol on the first test batch against the plain path (TF32 off), and
   that batch's time and profile; then stage 2 again from the same stage 1
   at 2 x dh 128 (``--exp-set num_heads=2``) with ``--test``: the test pass
   launches K5 in fp32 (the fp32 transform, then K1's fp32 kernel) 360 times
   a test batch and neither K9 nor a bf16 DiT kernel, training the bf16 K5
   and K6; its fp32 protocol against the plain path, its batch's time and
   profile;
15. peptide_loop: the 4AA workload through the port's entry points at full
   width on synthetic peptides: ``train.cli`` stage 1 (fp32, B=512, three
   steps, val), stage 2 read from the run registry (the bf16 DiT of depth 7,
   hidden 384, 16 x 24, T = 1000, B=16, the geometry aux losses, three
   steps, val over one batch, ``--test`` pointing to the eval CLI), then
   ``analysis.eval_cli`` (the fp32 DiT, dopri5 atol 1e-6 / rtol 1e-3, two
   test peptides in one batch x two rollouts, PDB files, the
   torsion/TICA/MSM JSD summary): return codes, finite metrics and JSD, the
   eval launching the fp32 K8, K3, K2 and K7 and no bf16 DiT kernel,
   training the bf16 ones and K4; stage 2's loss and grads and one fp32
   Euler-10 window against the plain path; step times, each window's dopri5
   steps and solve time, the eval's wall time and the window's profile; then
   stage 2 at 3 x dh 128 (``--exp-set num_heads=3``, three steps) and
   ``eval_cli`` on it: K5 in fp32 and K8-fp32 seven times an NFE, no K3 and
   no bf16 DiT kernel; one fp32 window at 3 x 128 against the plain path,
   its NFE, time and profile;
16. fp32_train: fp32 training on the card. Both registries' ``--smoke``
   stage 2 through ``train.cli`` in a temporary workspace (stage 1, then
   stage 2 from the run registry, MD17's with ``--test``): every call
   returns 0, every metric is finite, stage 2 launches K8-fp32 and K9-fp32
   forward and backward and no bf16 DiT kernel. Then the fp32 stage-2 train
   step (``dit_dtype="float32"``) at full width through the registries'
   loss, AdamW, clip and EMA: MD17 (depth 4, hidden 256, T=30, L=192,
   B=64, per-layer checkpointing) at 16 x dh 16 and 2 x dh 128, 4AA (depth
   7, hidden 384, T=1000, L=2, B=16) at 16 x dh 24 and 3 x dh 128: grads
   at B=2 against the plain path (TF32 off), the launches of every kernel
   per step (the checkpointed recompute included), every grad finite and
   non-zero, a few steps on one batch in which the SI loss falls, step
   times of both paths and peak memory, a profiled step at 16 heads;
17. ped_nba_loop: the pedestrian (ETH/UCY) and NBA workloads through
   ``train.cli`` in a temporary workspace at the registries' full widths on
   synthetic data (PN_DATA): stage 1 (fp32, B=512 / B=1024, one epoch with
   val; its attention axes are too short for a kernel, so it launches
   none), then stage 2 from the run registry (the bf16 class-conditional
   DiT of depth 6, T=20: hidden 128 at 4 x dh 32 over L=2 latents /
   hidden 256 at 16 x dh 16 over L=8, B=256 / B=1024, one epoch, val over
   one batch a loader, the min-over-K val hook) with ``--test`` (the fp32
   rebuild, K=20 / K=60 one repeat at a time over the first test batch of
   each loader, NBA with the k-means final-position clustering): return
   codes, complete and finite metric streams, the test keys (NBA's
   ``_post`` ones), the exact launches of training (steps x (K8, K9, K2 per
   layer, two K7 per layer and one more, K9's backward per layer) plus the
   val forwards), of the hook and of the test pass (depth x 9 drift
   evaluations x K x test batches, on the fp32 kernels alone: K8-fp32 and
   K2-fp32 on their outer-product kernels, none on a dot-product route);
   the test pass's time; one profiled
   repeat of a test batch; the fp32 protocol on one test batch (its first
   PN_CMP_ROWS windows) through the kernels against the plain path on the
   same noise (within PN_METRIC_REL_TOL) with both paths' times; then the
   bf16 stage-2 step at full width (``stage_checks``: grads against the
   plain path at B=2 within PN_S2_GRAD_REL_TOL, launches, ten steps with a
   falling SI loss, step times of both paths, NBA's step profiled).
18. trajio: raw MD files of synthetic peptides (``tools/synthetic_md.py``: PDB
   topologies with hydrogens, XTC / DCD / multi-model PDB trajectories; 8
   train peptides of 1,100 frames and a held-out one) through the port's
   ``tools/process_4aa`` (the native XTC codec, built with g++) into
   ``train.cli`` with ``--data-root`` at full width: hydrogens stripped,
   each npz the decoded frames after ``superpose_center`` and the written
   ones within the codec's bound, each state0 PDB parsed; stage 1 (fp32,
   B=512, three steps, val) and stage 2 (the bf16 DiT of depth 7, hidden
   384, 16 x 24, T=1000, B=16, three steps, val): return codes, finite
   metric streams, stage 2's launches of K1/K3, K2, K4, K7 and K8, step
   times. Then the loaders' host batch on the native batch engine and on
   the numpy forms (MD17 stage 1 at B=256, MD17 stage 2 at B=64, NBA stage 2
   at B=1024; median of 5; the batches agree, the engine's counter moves)
   beside phases 10 and 17's step times, and one smoke sweep
   (``experiments.sweeps.run_sweep("peptide", smoke=True)``) in-process.
19. parallel: the port's parallel/ on the one card. (i) An NCCL process
   group of world size 1 and its mesh; the 4AA stage-2 B=16 train step of
   phase 7 at both head splits under the data-parallel step (its batch a
   ``LocalBatch`` whose rows are the whole batch, its draws made for those
   rows, its grads all-reduced once over the one-rank group) and under
   FSDP2's ``fully_shard`` (DiT layers and root; its grads reduce-scattered
   by FSDP2), each from the unwrapped step's starting weights, batch and
   seed: the loss equal within PAR_LOSS_REL_TOL, each updated parameter's
   move within PAR_MOVED_REL_TOL of the unwrapped step's, the launches of
   every kernel the unwrapped step's, one grad all-reduce in the DP step
   and none in the others, and every draw of the wrapped steps made under
   a LocalBatch's rows. (ii) Ring attention
   as a ring of P=4 chunks in one process (two NCCL ranks cannot share the
   card) at [2,16,1000,24] and [2,3,1000,128] bf16: forward and the grads
   of q, k, v against one K1 + K4 call on the whole sequence
   (PAR_RING_REL_TOL), K1 P*P times forward and K4 P*P times backward,
   with both paths' times. (iii) ``analysis.callbacks.make_peptide_sampling_hook``
   once (figures off) on phase 15's trained 4AA stage-2 run (its
   checkpoint's weights and EMA, its val peptides): every peptide sampled
   (the hook prints none as failed), finite JSD summary, its launches.

Phase 3 also holds the fp32 backward kernels of fp32 training to their
plain versions with TF32 off: K9-fp32's backward (csrc/short_attention_f32.cu)
at [12288, 30, 256] and the smoke DiTs' 4 x dh 8, and both of K9-fp32's
kernels at their tiles' edges (K9_F32_EDGE_SPECS: n 9 to 127, dh 5 to 64,
uneven head groups, views that take 4-byte copies); K4-fp32's narrow kernel
(csrc/flash_attention_bwd.cu, dh <= 64) at the 4AA fp32 step's
[32,16,1000,24] and a ragged dh-20 shape (and, with the MD17 rows below, at
[1920,16,192,16], [1920,2,192,16], [256,8,192->32,16] with the bias and a
ragged dh-24 shape with an all-masked row) and its wide kernel at dh 128
at [16,3,1000,128], [1920,2,192,128], [12288,2,30,128] and a ragged dh-96
shape, a second call bit-identical at each; K6-fp32 at [16,3,1000,128]
(and the whole K5-fp32 + K6-fp32 autograd chain), and
K8-fp32's grads through its autograd Function at [16000, 2, 384], each
timed beside its plain version, its bound and SDPA's fp32 forward +
backward less forward.

Phase 3 also holds K10 (at both head splits and a ragged T, and against
the K5 and K3 routes, beside the composition of the plain pre_transform and
SDPA) and K11 (against K4's grads, with its peak memory, and in fp32 at a
JAX test shape) to their plain versions; and, at the pedestrian and NBA
DiTs' shapes (``ped_nba_kernel_checks``: x [5120, 2, 128] and
[20480, 8, 256], q/k/v [512, 20, 128] and [8192, 20, 256]), K8, K9 forward
and backward, K2 and K7 in bf16 and in fp32 (TF32 off; K8-fp32 and K2-fp32
on their outer-product kernels, each bit-identical to its dot-product route
launched directly), each with its bound and SDPA or the PyTorch composition
beside it; and K8-fp32's dot-product route at the tiny registries' hidden
32 (``k8_f32_dot_check``), the widths it still takes.

K1 and K3 without a mask in bf16 and K4 without one run the kernels
redesigned for Hopper (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu); phase
3 holds them at every main-path shape: K1 at [4,16,1000,24] and
[16,16,1000,24] and with the lse at [32,16,1000,24], K3 at [16,1000,384]
and [9600,192,256] and with the lse at [1920,192,256], K4 at
[32,16,1000,24] and [1920,16,192,16], and K1 on its cp.async route (dh 20).
K5 and K6 run the same pair on q/k that the transform kernel
(csrc/qk_normrope.cu) norms and rotates once; phase 3 holds the transform
against ``pre_transform``, K5 at [4,3,1000,128] and [16,3,1000,128] and
with the lse at [32,3,1000,128], and K6 at [32,3,1000,128], at a ragged
shape and on the cp.async route, each beside the composition of the plain
``pre_transform`` and PyTorch's attention.
Every attention row's bound also counts its exponentials (one a score).
K9 (forward and backward) and K11 are also redesigned for Hopper (mma.sync
and wgmma tiles; csrc/short_attention.cu, csrc/short_backward.cu), and K2
(csrc/fused_mlp.cu: TMA-fed wgmma GEMMs back to back, the GELU between them
on chip), and K8 (csrc/fused_spatial_block_sm90.cu: the whole spatial block
on TMA-fed wgmma GEMMs with linear1 computed once a row); phase 3 also
checks that two calls of each on the same inputs give bit-identical
results, prints the route each K2 row took (every one must take the Hopper
kernel with x by TMA; the counters of its WMMA route and its cp.async
loads stay 0 on every main path) and, beside K2's plain time, the two-GEMM
cuBLAS composition's, and beside K8's the two bare cuBLAS GEMMs of its
shapes. K8 runs its Hopper route at every main-path shape (its WMMA
route's counter stays 0 on every main path, phase 13's tiny DiT aside) and
is held to its plain version at the 4AA widths at L = 1, 3 and 8, at the
NBA and pedestrian widths, and on the WMMA route at hidden 32. K7's rows
give its device time (profiler) beside the wrapper's event time.

The MD17 kernels are checked against their plain versions in phase 3: K1
with the key-padding bias and with fp32 operands (and its lse), K9 forward
and backward at the protocol's shapes, K3, K2 and K7 at the DiT's 1.84 M
tokens, and K4 with the bias (fp32 and bf16) and with fp32 operands at the
training shapes, each also at ragged shapes with an all-masked row; and the
fp32 instances the test pass runs (K2-fp32, K7-fp32, K9-fp32's forward;
csrc/fused_mlp_f32.cu, fused_adaln_f32.cu, short_attention_f32.cu, FFMA,
no TF32) at its shapes, with TF32 off on the plain side; K1 in fp32 and
with the bias runs the narrow register-tiled kernel
(csrc/flash_attention.cu, dh <= 64), held there at stage 1's shapes and,
as K3-fp32, at the fp32 DiT's spatial axis [1920, 192, 256]. Likewise the
fp32 kernels of the 4AA eval's DiT: K8-fp32's outer-product kernel
(csrc/fused_spatial_block_f32.cu) at [8000, 2, 384] and [2000, 2, 384] at
both head splits, beside the two bare cuBLAS SGEMMs of its shapes and
bit-identical to its dot-product route, and K3-fp32 (the narrow kernel),
K2-fp32 and K7-fp32 at the 4AA widths. Every fp32 path's launches show K1
at dh <= 64 on the narrow kernel and K8 on the outer-product one. And the
fp32 kernels of the dh-128 splits (DH128_SPECS): K1's
fp32 kernel at 64 < dh <= 128 (dh 72, 96, 128; N 20, 30, 77, 192, 1000;
with the lse and the key-padding bias; 66,000 batch x heads), the fp32
transform and K5-fp32 at the 4AA eval's [B, 3, 1000, 128] and MD17's
[1920, 2, 192, 128] and [12288, 2, 30, 128], each beside SDPA in fp32 (and
for K5 the plain pre_transform + SDPA); and bf16 K5 and K6 at those two MD17
shapes, which the 2 x 128 training gives them.

The last lines are a JSON summary of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero. Run from the repository root:

    python3 chip_smoke.py
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

T, L, DIN, DEPTH, HIDDEN, HEADS, MLP_RATIO = 1000, 2, 96, 7, 384, 16, 2
WIDE_HEADS = 3  # the 3 x dh 128 split
NUM_STEPS = 10
DRIFT_EVALS = NUM_STEPS - 1  # ode_fixed takes num_steps - 1 Euler steps
SEED = 0
DOPRI5_BATCH = 8
DOPRI5_MAX_STEPS = 1000  # ode_dopri5's bound on attempted steps

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel could
# take is the larger of its tensor-core FLOPs over the bf16 rate and its
# bytes (each input read once, each output written once) over HBM's rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
# Attention also needs one exponential a score (two a score on kernels that
# recompute P): ex2 runs on the special-function units, 16 per SM per clock,
# ~3.9 T/s on the card (the FlashAttention-3 paper, Shah et al. 2024, gives
# the same). A bound counts one a score.
PEAK_EXP_RATE = 3.9e12

# K1 against its plain version: both round the output to bf16, and P is
# rounded to bf16 before the running-max rescale in the kernel but after
# normalization in the plain version, so the two differ by about one bf16
# ulp (measured 3.906e-3 at max |out| 0.617 on an H100). The limit is
# K1_ULPS ulps of bf16 at the largest |out|. A second check catches a
# uniform shrink or growth: the gain mean(got*want) / mean(want^2) must be
# within K1_GAIN_TOL of 1. Control: a K1 built without the last-tile key
# mask (T=1000 is 24 keys short of 16 tiles of 64, and zero-filled keys get
# logit 0) gave, on an H100 at [4,16,1000,24], a max error of 7.812e-3
# (2 ulps, inside the first limit) and a gain of 0.9861 (caught by the
# second); the correct K1 gave a gain within 6e-6 of 1. K3 and K5 are K1's
# binary on other views and with the QK transform, held to the same pair.
K1_ULPS = 2
K1_GAIN_TOL = 1e-3
# K2: the mid and gelu(mid) roundings to bf16 can land one ulp apart when
# fp32 sums are taken in another order; each flip moves an fp32 output by
# about ulp(mid) * |w2| ~ 4e-3 * 0.05, and outputs have |out| ~ 1.
K2_ATOL = 1e-2
# K7: x_new = x + bf16(gate * h) rounds per op as the plain version does,
# so it must be bit-identical; y may differ by K7_ULPS bf16 ulp at max |y|
# where the fp32 mean/variance, summed in another order, flip a rounding.
K7_ULPS = 1
# K8, relative to max |out|: bf16 roundings of linear1, the norm, the
# softmax weights and linear2 that land one ulp apart when fp32 sums are
# taken in another order. First reading on an H100: 4.348e-3 (3 x 128,
# [2000,2,384]; 2.212e-3 to 3.788e-3 at the other three shapes); the limit is
# 3x that.
K8_REL_TOL = 1.3e-2
# The model output of one full-width forward (the model call of one drift
# evaluation; the drift itself adds a noise term of the same size that
# would hide the model's error), relative to max |out|. Kernel path vs plain
# path, both bf16: 7 layers whose bf16 roundings differ in order; measured
# 3.185e-3 on an H100, the limit is 3x that.
MODEL_REL_TOL = 1e-2
# The kernel path against a float32 copy of the model on the plain path:
# measured 7.078e-3 on an H100, the limit is 3x that.
MODEL_FP32_REL_TOL = 2e-2
PROFILE_TOP = 12  # kernels listed per profiled solve
QUEUE_FULL = "Command Buffer Full"  # a profiler event of the host, not a kernel
# K4/K6 against their plain backwards, per grad, relative to its max |grad|:
# both round the grads to bf16 and P and dS to bf16 at the same points, but
# a differently summed fp32 value can land one bf16 ulp apart. First
# readings on an H100 (this script, at the four shapes of backward_checks):
# up to 1.479e-3 for K4 and 2.890e-3 for K6; each limit is 3x that (K6 on
# the redesigned pair, since: up to 3.425e-3, inside it). Each
# grad's gain must also be within K1_GAIN_TOL of 1, which catches a uniform
# shrink (an unmasked key or query tile) that stays inside the max-error
# limit.
K4_REL_TOL = 4.5e-3
K6_REL_TOL = 8.7e-3
# The transform kernel (K5's and K6's QK RMS-norm + RoPE, written once)
# against pre_transform, at the same rounding points: a normed value may
# round one bf16 ulp apart where the kernel's fp32 sum of squares (a warp
# shuffle) and PyTorch's reduction are taken in another order, and the
# rotation carries it into both elements of its pair, so each element is
# measured in bf16 ulps at the magnitude of its (even, odd) pair: one flip
# moves the pair's elements by up to about 3 such units (the rotation, then
# each side's own rounding). Readings on an H100, this script's and those of
# python -m lam_slide_tpu_torch.tools.lse_readings (six seeds a shape, five
# shapes): at most 2.0 pair ulps, on at most 5.859e-6 of the elements (dh
# 24, where the mean's division is inexact; at dh 128 at most 1.221e-7, and
# none on most inputs). Limits: 4 pair ulps, on at most 3x that share or on
# one pair (2 elements), whichever is more.
TRANSFORM_PAIR_ULPS = 4
TRANSFORM_DIFF_SHARE = 1.8e-5
# lse against the plain log-sum-exp, absolute, per kernel and head dim. K1:
# fp32 sums in another order, a few fp32 ulps of lse ~ 8. K5: also the bf16
# rounding of the transformed q/k, where the kernel's and PyTorch's fp32
# norm statistics, summed in another order, put an element one bf16 ulp
# apart; one such flip on a row's largest logit moves its lse by up to
# ulp(|q_t|) * |k_t| * scale, a few 1e-2 here. How often that happens
# depends on the data more than on the shape, so each limit is 3x the worst
# reading at its head dim over every input read on an H100: this script's,
# and six seeds per shape of python -m lam_slide_tpu_torch.tools.lse_readings
# (the GPU test's shapes and the train shapes). Worst readings, K1: 1.907e-6
# (dh 24; 2.861e-6 at one seed of the train shape in a later reading, inside
# the limit), 2.861e-6 (dh 64), 7.629e-6 (dh 128); K5: 6.638e-3 (dh 24),
# 7.629e-6 (dh 64), 3.605e-4 (dh 128). K5's transform runs in a kernel of
# its own since the readings at dh 128 that gave 8.698e-3 (and the limit
# 2.6e-2): it flips far fewer elements at dh 128 (at most 1.221e-7 of
# them), so that limit was taken again from the new readings. A K5 lse that
# is off by more than a flip shows in K6 too, whose dq/dk/dv gains
# recompute P from it.
LSE_ATOL = {"K1": {24: 6e-6, 64: 9e-6, 128: 2.3e-5},
            "K5": {24: 2e-2, 64: 2.3e-5, 128: 1.1e-3}}
# Train step (registry, peptide stage 2): B=16, AdamW lr 1e-3, weight decay
# 0.01, clip 0.5, EMA 0.999, warmup-cosine over 1500 epochs; the schedule is
# built with one step per epoch, so the ten steps here run at lr ~1e-3.
TRAIN_BATCH, TRAIN_EPOCHS, CLIP, EMA_DECAY = 16, 1500, 0.5, 0.999
TRAIN_STEPS = 10
GRAD_BATCH = 2
TIMED_STEPS = 5
# Grads at B=2, kernel path against the plain path on the same weights and
# batch (fixed t and x0): the relative error of the global grad norm and the
# worst per-tensor ||g - g_ref|| / ||g_ref||, where bf16 activations rounded
# in another order move the smallest grads most (the QK-norm scales). First
# readings on an H100, worst of the two splits: against the plain bf16 path
# 2.572e-5 and 5.259e-3, against a float32 plain copy 1.008e-3 and
# 1.506e-2. Each limit is 3x that.
# MD17 (experiments/registry.py:155-300): the protocol's K=5 repeats,
# Euler-10, B=64 trajectories of T=30 frames, molecules padded to 32 atoms;
# stage 1 trains on B=256 single frames.
MD17_BATCH, MD17_K, MD17_T, MD17_ATOMS = 64, 5, 30, 32
MD17_S1_BATCH = 256
MD17_DRIFT_EVALS = DRIFT_EVALS
MD17_DEPTH = 4
# Synthetic trajectory frames per molecule (data/md17.py's fallback when no
# raw MD17 file exists): after the 10x downsampling and the 0.6/0.2/0.2
# split this fills the reference's 5000 train windows and the 256 val
# windows the registry keeps, as the real trajectories do.
MD17_FRAMES = 100_000
# K1 with fp32 operands against its plain version, relative to max |out|:
# both are exact fp32 up to the order of the sums and the kernel's online
# rescale, a few fp32 ulps (~80 ulps allowed; first readings on an H100 at
# the protocol shapes: 5.013e-7 with the bias, 9.065e-7 without).
K1_F32_REL_TOL = 1e-5
# K9 forward: K1's pair of limits (bf16 weights rounded at the same point
# as the plain version, sums in another order). K9 backward per grad,
# relative to max |grad|: P and dS round to bf16 at the same points, but a
# weight summed in another order (the plain softmax's) can land one bf16
# ulp apart and move dV by that ulp times |dO|. First reading on an H100 at
# the protocol shape: 2.857e-3 (dv); the limit is 3x that. The gain of each
# grad must be within K1_GAIN_TOL of 1.
K9_GRAD_REL_TOL = 8.6e-3
# K4 with fp32 operands (and K1-fp32's lse) against the plain versions, per
# grad relative to its max |grad|: both are exact fp32 up to the order of the
# sums, like K1-fp32, so the same limit. First readings on an H100 at the
# MD17 training shapes and ragged ones: 0 (bit-identical) for every grad;
# K1-fp32 lse within 1.431e-6 (the K1 lse limit at dh 24 covers it 4x).
K4_F32_REL_TOL = 1e-5
LSE_F32_ATOL = 6e-6
# MD17 train steps, kernel path vs plain path on the same draws, at each
# stage's starting weights (before any step): (relative error of the global
# grad norm, worst per-tensor ||g - g_ref|| / ||g_ref||). Stage 1 at B=256
# in fp32: exact fp32 on both sides up to the order of the sums. Stage 2 at
# B=2: the bf16 DiT (whose roundings differ in order, as at 4AA) and the
# fp32 aux decode. Each limit is 3x the largest reading of
# tools/md17_grad_readings.py on an H100 over seeds 0-3, from this tree's
# kernels and from the older attention template's alike: stage 1 5.025e-8
# and 6.749e-7, stage 2 1.936e-5 and 3.985e-3. A plain path in TF32 reads
# 8.4e-4 and 1.2 (stage 1), 4.4e-3 and 0.16 (stage 2) at the least; the
# softmax weights at bf16 precision in stage 1's fp32 attention 1.3e-5 and
# 3.8e-4. At stage 2's B=2 the softmax weights at 6 or 3 mantissa bits read
# like the kernel path (1.0e-6 to 2.4e-5): this check does not see the
# bf16 attention's precision; phase 3's K1/K4 rows do.
S1_GRAD_REL_TOL = (1.5e-7, 2.0e-6)
MD17_GRAD_REL_TOL = (5.8e-5, 1.2e-2)
# Decoded positions of the MD17 protocol batch, kernel path vs plain path on
# the same weights and noise, relative to max |pos|: nine Euler steps of a
# bf16 DiT whose roundings differ in order, then the fp32 decoder. First
# reading on an H100: 4.875e-4; the limit is 3x that.
MD17_POS_REL_TOL = 1.5e-3
# The MD17 test pass (phase 14) runs the DiT in fp32: MD17_LATENTS latents of
# MD17_HIDDEN, 16 heads of 16, at the loaders' B=64. Its fp32 kernels
# (K2-fp32, K7-fp32's y, K9-fp32's forward) against their plain versions
# with TF32 off, relative to max |out|: exact fp32 on both sides up to the
# order of the sums (and erff, expf against PyTorch's erf, exp). Readings of
# python -m lam_slide_tpu_torch.tools.f32_readings on an H100 (seeds 20-23
# at the test pass's shapes), worst: K2 0 (bit-identical: cuBLAS's SGEMM,
# with TF32 off, sums each output over k in order with FMAs, as the kernel
# does), K7 1.571e-7, K9 5.470e-7. Each limit is 3x the worst reading; K2's
# is a floor of 1e-6 instead of 0, a few fp32 ulps for a cuBLAS algorithm
# that sums in another order. K7's x_new must be bit-identical.
MD17_LATENTS, MD17_HIDDEN, MD17_HEADS = 192, 256, 16
# Phase 14's synthetic aspirin trajectory: 12,000 raw frames, 1,200 after
# the 10x downsampling; with the split (0.6, 0.2, 0.2) and 30-frame windows
# that is 691 train windows (stage 1: 2 steps at B=256; stage 2: 10 steps
# at B=64) and 211 test windows (the test pass: 4 protocol batches).
MD17_LOOP_FRAMES = 12_000
# Phase 14's fp32 protocol on one test batch, kernel path vs plain path
# (TF32 off) on the same weights and noise, in fp32 ulps of the plain path's
# ADE and FDE (fp32 means over the batch): both run the fp32 DiT, with sums
# in other orders, through nine Euler steps. Readings on an H100 (phase 14's
# trained weights at seed 0, and python -m lam_slide_tpu_torch.tools.f32_readings
# at seeds 0-2): 0 ulps every time, the per-element differences (~1e-7
# relative) averaging out below one ulp of the mean. The limit is 3 ulps.
MD17_F32_PROTOCOL_ULPS = 3
F32_REL_TOL = {"K2 fp32": 1e-6, "K7 fp32": 4.8e-7, "K9 fp32": 1.7e-6}
GRAD_NORM_REL_TOL = {"bf16": 8e-5, "fp32": 3e-3}
GRAD_TENSOR_REL_TOL = {"bf16": 1.6e-2, "fp32": 4.5e-2}
# The 4AA eval (phase 15) runs the DiT in fp32 at the widths of the main
# path (hidden 384, 16 x 24, T = 1000, L = 2) at its B = 2 and the sampling
# B = 8: K8-fp32, K3-fp32 (K1's fp32 kernel at dh 24 over T = 1000), K2-fp32
# at 384 -> 768 -> 384 (the outer-product kernel, 32-row blocks at B = 2,
# 64-row ones at B = 8) and K7-fp32 at
# D = 384. Against their plain versions with TF32 off, relative to max
# |out|: exact fp32 on both sides up to the order of the sums (and erff,
# expf against PyTorch's erf, exp): K1-fp32's limit (a few fp32 ulps) for
# K8 and K3, the MD17 test pass's for K2 and K7 (F32_REL_TOL). Readings of
# python -m lam_slide_tpu_torch.tools.peptide_readings on an H100 (seeds
# 0-3): K8 up to 1.986e-6 (at [2000, 2, 384]), K3 2.852e-6, K2 0
# (bit-identical), K7 1.881e-7: all inside.
PEP_F32_REL_TOL = {"K8 fp32": 1e-5, "K3 fp32": K1_F32_REL_TOL,
                   "K2 fp32": F32_REL_TOL["K2 fp32"], "K7 fp32": F32_REL_TOL["K7 fp32"]}
# Phase 15, the 4AA workload through the CLI and eval_cli at full width on
# synthetic peptides (data/peptide.py's fallback): stage 1 at its B = 512 on
# the default 8 peptides x 1,200 frames, 192 visits of each a train epoch
# (``repeats``, the JAX registry's epoch-length knob): three steps; stage 2 at
# B = 16 on 8 peptides cut to 1,100 frames (from 2,000: the host's
# precompute, T = 1000 windows still fit), 6 visits each: three steps, val
# over one batch; eval_cli on 2 of its peptides x 2 rollouts, dopri5 atol
# 1e-6 / rtol 1e-3, fp32, the peptides in one batch.
PEP_S1_REPEATS = 192
PEP_S2_FRAMES, PEP_S2_REPEATS = 1100, 6
PEP_EVAL_IDS, PEP_ROLLOUTS = ("synth0", "synth1"), 2
# Phase 15's kernel path against the plain path, on weights perturbed by
# N(0, PEP_PERTURB_STD^2) (``perturb_``: the reference init makes every DiT
# block the identity, which no kernel moves): stage 2's metrics and grads
# before any step (B=2, the same t and x0; the bf16 DiT's roundings in
# another order, then the fp32 aux decode and geometry) as (worst metric
# rel err), (global grad norm rel err, worst per-tensor ||g - g_ref|| /
# ||g_ref||), and the decoded atom14 of one fp32 Euler-10 window (TF32 off;
# sums in another order through seven fp32 layers and nine steps), rel to
# max |pos|. Readings of python -m lam_slide_tpu_torch.tools.peptide_readings
# on an H100 (seeds 0-3, on the registry's random weights): metrics up to 7.761e-5;
# grad norm up to 1.578e-3; worst tensor up to 0.193, at the QK-norm scales
# (the smallest grads, moved most by bf16 activations rounded in another
# order) but for one seed's x_in (1.104e-2); the window up to 1.268e-6.
# Each limit is 3x the worst reading.
PEP_PERTURB_STD = 0.02
PEP_S2_LOSS_REL_TOL = 2.4e-4
PEP_S2_GRAD_REL_TOL = (4.8e-3, 0.58)
PEP_WINDOW_REL_TOL = 3.9e-6
# dh 128 in fp32: the fp32 sampling DiTs at 2 x dh 128 (MD17's --test pass,
# phase 14) and 3 x dh 128 (the 4AA eval, phase 15) run K5 in fp32: the fp32
# transform (csrc/qk_normrope.cu), then K1's fp32 kernel over 64 < dh <= 128
# (csrc/flash_attention.cu, register-tiled). Against their plain
# versions with TF32 off, relative to max |out| (the transform per tensor)
# and the lse absolute: exact fp32 on both sides up to the order of the sums.
# Readings of python -m lam_slide_tpu_torch.tools.dh128_readings on an H100
# (seeds 0-3 at the shapes of DH128_SPECS), worst: K1-fp32 at dh > 64
# 2.210e-6 (at [2,3,1000,128]), its lse 2.384e-6, the fp32 transform
# 2.122e-7, K5-fp32 2.326e-6 (at [8,3,1000,128]). Each limit is 3x the worst
# reading. Those readings were of a kernel that shared a row's dot products
# among four lanes; the register-tiled kernel reads at most 1.985e-6, lse
# 9.537e-7, K5-fp32 2.094e-6, inside the same limits.
K1_F32_WIDE_REL_TOL = 6.7e-6
LSE_F32_WIDE_ATOL = 7.2e-6
TRANSFORM_F32_REL_TOL = 6.4e-7
K5_F32_REL_TOL = 7e-6
MD17_WIDE_HEADS = 2  # the 2 x dh 128 split of the MD17 DiT (hidden 256)
# Phase 14's fp32 protocol at 2 x 128 on one test batch, kernel path vs plain
# (TF32 off), in fp32 ulps of the plain path's ADE and FDE, and phase 15's
# fp32 Euler-10 window at 3 x 128, kernel path vs plain on perturbed weights,
# relative to max |pos|. Readings of tools/dh128_readings.py on an H100
# (seeds 0-3, the registries' random weights): the protocol 0 ulps every
# time, as at 16 x 16, so its limit is phase 14's (3 ulps); the window up to
# 1.360e-6, the limit 3x that (1.292e-6 on the register-tiled K1-fp32).
MD17_WIDE_F32_PROTOCOL_ULPS = MD17_F32_PROTOCOL_ULPS
PEP_WIDE_WINDOW_REL_TOL = 4.1e-6
# fp32 training (phase 3's fp32 backward rows and phase 16, fp32_train): the
# fp32 backward kernels against their plain versions with TF32 off, per
# grad relative to its max |grad|: exact fp32 on both sides up to the order
# of the sums (K9-fp32's delta from unnormalised weights and P as e / l; K6
# the fp32 transform's q_t/k_t, then the chain VJP; K8-fp32 under autograd
# the kernel's forward, then the plain VJP). First readings on an H100 (the
# rows' seeds): K9-fp32's backward 8.094e-7, K6-fp32 7.374e-7 (the autograd
# chain's worst grad), K8-fp32's output 3.733e-7 (its grads bit-identical);
# K4-fp32's kernels sum dQ over the key tiles' shares, in another order than
# cuBLAS's one FMA chain a product, so both are held to K4_F32_REL_TOL. The
# others are 3x their reading.
K9_F32_GRAD_REL_TOL = 2.5e-6
K6_F32_REL_TOL = 2.3e-6
K8_F32_GRAD_REL_TOL = 1.2e-6
# Phase 16's full-width fp32 stage-2 steps at B = 2, the kernel path's grads
# against the plain path's (TF32 off) on the same weights and draws: the
# global grad norm's relative error and the worst per-tensor ||g - g_ref|| /
# ||g_ref||. First readings on an H100, worst of the four splits: 8.829e-8
# (4AA 16 x 24) and 2.431e-6 (4AA 16 x 24, a temporal QK-norm scale, the
# smallest grads); MD17 read 6.064e-9 and 1.914e-7. Each limit is 3x that.
F32_TRAIN_GRAD_REL_TOL = (2.7e-7, 7.3e-6)
F32_TRAIN_STEPS = 4  # steps on one batch and draw in which the SI loss falls
F32_TIMED_STEPS = 2  # timed steps of each path, in turns
# the MD17 smoke runs' and the full-width MD17 steps' synthetic raw frames a
# molecule (phase 14's: enough for B = 64 windows)
F32_MD17_FRAMES = 12_000
# the full-width 4AA steps' synthetic peptides: 2 of 1,100 frames, each
# visited 8 times an epoch (``repeats``), one B = 16 batch of T = 1000 windows
F32_PEP_PEPTIDES, F32_PEP_FRAMES, F32_PEP_REPEATS = 2, 1100, 8
# K10 against its plain version: K1's pair of limits (q/k round once, after
# norm and RoPE, on both sides; P rounds at different points). Against the
# K5 route and the K3 route on the same raw q/k/v, which round q/k twice
# (after the norm and after the RoPE): relative to max |out|, and the gain.
# A one-ulp difference of a transformed q/k element moves a logit by about
# 2^-8 of its size, so outputs move by a few bf16 ulps. First readings on an
# H100: 8.523e-3 (3 x 128) and 1.036e-2 (16 x 24); the limit is 3x that.
K10_ROUTE_REL_TOL = 3e-2
# K11 against its plain version: K4's formulas at K4's rounding points, so
# K4's limits (K4_REL_TOL in bf16, K4_F32_REL_TOL in fp32); against K4's
# grads on the same out/lse, twice that (each is held to the plain version;
# the first reading on an H100 was bit-identical).
# Phase 11, the fused temporal block at 3 x 128 against its plain path, the
# output relative to max |out|: first reading on an H100 4.310e-3, the limit
# is 3x that; its grads per tensor are held to GRAD_TENSOR_REL_TOL["bf16"]
# (first reading 6.241e-3, the key-norm scale).
BLOCK_REL_TOL = 1.3e-2
# Phase 12, the samplers on the 4AA 16 x 24 DiT: the reference's default
# steps at B=8, and at B=2 the kernel path against the plain path on the same
# noise and eps with fewer steps, relative to the largest output. First
# readings on an H100: SDE x 6.150e-3, likelihood logp 2.021e-6 and end
# state 1.358e-3 (the data drift divides by sigma_t^2 near the end of the
# interval, so random weights give |logp| ~ 1e11); the limit is 3x the worst.
SDE_STEPS, LIKELIHOOD_STEPS = 250, 50
SAMPLER_BATCH = 8
SOLVE_CMP_STEPS = (5, 4)
SOLVE_REL_TOL = 1.9e-2

# The pedestrian and NBA workloads (phase 3's rows at their shapes, phase
# 17): their stage-2 DiTs (composites/pedestrian.py, composites/nba.py) have
# depth 6, T = 20 frames (8 condition the other 12) and mlp_ratio 2;
# (batch, hidden, heads, L, K) per workload: the registries' stage-2 B, the
# DiT's width and head split, its latents and the test protocol's K.
PN_DEPTH, PN_T = 6, 20
PN_SHAPES = {"pedestrian": (256, 128, 4, 2, 20), "nba": (1024, 256, 16, 8, 60)}
# Phase 17's synthetic data (data/pedestrian.py's and data/nba.py's
# fallbacks; the real ETH/UCY and SocialVAE files are not in the
# repository): (the registry knob, stage 1's size, stage 2's size). The
# pedestrian sets hold that many scenes of each of the five, so stage 1
# takes 2 steps at B = 512 and stage 2 5 at B = 256; an NBA stage-1 epoch
# draws one frame a game, so 2,048 games give 2 steps at B = 1024, and 46
# games of 64 frames give 2,070 windows: 2 stage-2 steps at B = 1024 and
# one test batch of 1,024.
PN_DATA = {"pedestrian": ("synthetic_scenes", 256, 256),
           "nba": ("synthetic_games", 2048, 46)}
# The kernel path against the plain path on one test batch (phase 17): its
# first PN_CMP_ROWS windows (the test pass itself runs the whole batch), the
# test model's weights perturbed as phase 15 perturbs them (``perturb_``),
# the protocol's K, num_runs and FPC, the same noise, TF32 off: the largest
# relative difference of the batch's metrics. Stage 2's bf16 step: the
# grads at B=2 against the plain path (global norm rel err, worst
# per-tensor ||g - g_ref|| / ||g_ref||). Readings of
# python -m lam_slide_tpu_torch.tools.ped_nba_readings on an H100 (seeds
# 0-3, the registries' random weights): the protocol 0 at the pedestrian
# width at every seed, up to 4.769e-6 at NBA's (an FPC metric: k-means
# assignments and the nearest sample move with fp32 sums in another
# order); the grads' norm up to 3.520e-5 and a tensor up to 4.973e-3 (the
# class embedding, a QK-norm scale, time_in). Each limit is 3x the worst.
PN_CMP_ROWS = {"pedestrian": 256, "nba": 256}
PN_METRIC_REL_TOL = 1.5e-5
PN_S2_GRAD_REL_TOL = (1.1e-4, 1.5e-2)
# Phase 18 (trajio): raw MD files of synthetic peptides
# (lam_slide_tpu_torch/tools/synthetic_md.py: PDB topologies with hydrogens,
# XTC / DCD / multi-model PDB trajectories by turns) through the port's
# process_4aa into the 4AA CLI with --data-root: as many train peptides and
# frames as phase 15's stage 2 (so its T = 1000 windows fill B = 16), and one
# held-out peptide for val and test.
TRAJIO_TRAIN, TRAJIO_PRECISION = 8, 1000.0
TRAJIO_FORMATS = ("xtc", "dcd", "pdb")
# What each codec keeps of a written coordinate, in nm (XTC: a grid of
# 1 / precision; PDB: Å to 3 decimals; DCD: float32 Å), each plus 2 float32
# ulps of the largest coordinate; the processed frames against the written
# ones after superpose_center within TRAJIO_FIT_FACTOR times that (centering
# adds the mean error, the fit onto frame 0 carries frame 0's errors: at most
# 1.9x in tests/test_torch_port_process_4aa.py's readings).
TRAJIO_CODEC_BOUND = {"xtc": 0.5 / TRAJIO_PRECISION, "pdb": 5e-5, "dcd": 0.0}
TRAJIO_FIT_FACTOR = 4.0
# The loaders' host batch (phase 18), engine against numpy: the median of
# HOST_REPS batches each; floats within HOST_FLOAT_TOL, integers bit for bit
# (the limits of tests/test_batch_assembly.py:68,79).
# phase 19: the wrapped steps take the unwrapped step's loss (the forward
# is the same computation) and move each parameter as it does; the bf16
# backward sums dQ in a varying order, so updates are held to their move:
# on an H100 at 700 W the unwrapped step repeated read up to 4.07e-3 of a
# tensor's move, the wrapped ones 4.66e-3
PAR_LOSS_REL_TOL = 1e-6
PAR_MOVED_REL_TOL = 2e-2
PAR_RING_CHUNKS = 4
PAR_RING_SHAPES = ((2, 16, 1000, 24), (2, 3, 1000, 128))
# the ring merges the chunks' bf16 outputs (and sums their bf16 grads) in
# fp32: a few bf16 ulps against one K1 + K4 call, as a norm ratio
PAR_RING_REL_TOL = 1e-2
# Tensor parallelism (phase 20, parallel/tp.py), every shard of a block in
# one process on the one card: the 4AA splits (heads, tp) and the MD17 DiT's
# tp. The forward keeps the unsharded block's rounding points (linear2's
# fp32 sums taken shard by shard, one rounding after them): the loss within
# TP_LOSS_REL_TOL (first reading 8.8e-8 at 16 x 24 tp 2). The backward
# cannot: each shard's grad of the block input is rounded to bf16 before
# the shards' grads are summed (Megatron's and GSPMD's bf16 TP alike), so
# the grads at B=2 are held to the limits of the kernel path against the
# plain path (GRAD_NORM_REL_TOL, GRAD_TENSOR_REL_TOL; MD17's
# MD17_GRAD_REL_TOL), which differ in rounding points the same way. A first
# AdamW step moves each element by about lr wherever its grad is not ~0, so
# an element whose grad is at that noise moves the other way: the moves,
# beside the unsharded step's own repeat (its K4 dQ order; 2.3e-3), read
# 4.118e-2 at time_in.in_layer.weight at 16 x 24 tp 2 on an H100
# (its grad sums every block's modulation grads); TP_MOVED_REL_TOL bounds
# them at 0.1, where a wrong shard (a head's grad lost or counted twice)
# moves a whole tensor (CPU tests: fp32 TP equals one rank within 2e-4).
TP_SPLITS = ((HEADS, 2), (HEADS, 4), (WIDE_HEADS, 3))
TP_MD17 = 2
TP_LOSS_REL_TOL = 1e-4
TP_MOVED_REL_TOL = 0.1
# phase 20's bf16 4AA step at 16 x 24 tp 8, whose ranks (Da 48) have no
# Hopper plan: K8 on the WMMA partial; the NBA-width forward's tp (Da 32)
TP_WMMA_SPLIT = (HEADS, 8)
TP_NBA = 8
# phase 20's fp32 lines (TF32 off), against the unsharded fp32 step on the
# same weights and draws. The fp32 path keeps every rounding point of the
# unsharded one and changes only the order of fp32 sums: linear2's product
# summed shard by shard, the block input's and the QK-norm scales' grads
# summed over the shards. The unsharded fp32 step's own repeat is the noise
# floor: on an H100 at 700 W it read 0 on every line, loss, grads and moves
# bit for bit, at 4AA (both splits) and MD17 (no atomics on the fp32
# path), so each limit rests on what sum order alone moves, read once:
# - the loss: 8.764e-8 (one fp32 ulp of a loss of 1.36) at 3 x 128 tp 3 and
#   MD17 tp 2, 0 at 16 x 24 tp 2 and 4; the limit is 4 ulps there, 3.5e-7;
# - the grads at B=2: norm up to 2.385e-9, a tensor up to 6.766e-7 (a
#   QK-norm scale): held to F32_TRAIN_GRAD_REL_TOL, the kernel path against
#   the plain path in fp32, which differ in sum order the same way;
# - the moves of AdamW's first step: up to 3.392e-5 of a tensor's move (a
#   QK-norm scale at 16 x 24 tp 2); 3x that, 1e-4 (the bf16 lines need 0.1:
#   there each shard's input grad rounds to bf16 before the sum);
# - the NBA-width forward at tp 8: 4.166e-7 of the largest output; 3x,
#   1.3e-6.
TP_F32_LOSS_REL_TOL = 3.5e-7
TP_F32_MOVED_REL_TOL = 1e-4
TP_F32_FWD_REL_TOL = 1.3e-6
TP_SOLVE_BATCH = 8
HOST_REPS = 5
HOST_FLOAT_TOL = 1e-5
# Kernel-path step times (ms, median) that stage_checks measured, by
# "<phase> <label>": phase 18 prints the host batch times beside them.
STEP_MS = {}

def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def with_sm90(want: dict, k4_fp32_calls: int = 0) -> dict:
    """``want`` with the launches of the redesigned kernels that follow from
    its K1, K4, K5 and K6 counts: every bf16 K1 call without a mask is one
    launch of flash_fwd_sm90.cu and every bf16 K4 call without a mask three
    kernels of flash_bwd_sm90.cu (preprocess, main, dQ); every K5 call one
    transform launch and one of flash_fwd_sm90.cu, and every K6 call (from
    autograd, on the forward's q_t/k_t: no transform) three kernels of
    flash_bwd_sm90.cu; all on the TMA route at the main paths' shapes. On
    the main paths every masked call is fp32 (K1 bias within K1 fp32; the
    fp32 K4 calls, ``k4_fp32_calls`` of them, count their own kernels)."""
    check(want["K1 bias"] <= want["K1 fp32"] and want["K4 bias"] <= want["K4 fp32"],
          f"a bf16 masked call among the expected launches {want}")
    return with_routes(dict(want, **{"K1 sm90": want["K1"] - want["K1 fp32"],
                                     "K4 sm90": 3 * (want["K4 kv"] - k4_fp32_calls),
                                     "K5 transform": want["K5"], "K5 sm90": want["K5"],
                                     "K6 sm90": 3 * want["K6"], "K1 cp.async": 0,
                                     "K4 cp.async": 0, "K5 cp.async": 0, "K6 cp.async": 0}))


def with_routes(want: dict) -> dict:
    """``want`` with the fp32 kernels' routes that follow from its counts on
    the main paths: every fp32 K1 call at dh <= 64 (those not on the wide
    kernel) on the narrow kernel, no K5 call on it (K5 runs at dh 128), and
    every fp32 K8 call on the outer-product kernel (the 4AA, NBA and
    pedestrian widths), none on the dot-product route."""
    return dict(want, **{"K1 fp32 narrow": want["K1 fp32"] - want["K1 fp32 wide"],
                         "K5 fp32 narrow": 0, "K8 fp32 tiled": want["K8 fp32"],
                         "K8 fp32 dot": 0})


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, match, reps: int = 20, attempts: int = 3) -> float:
    """Device time a call of fn of the kernels whose name holds ``match`` (a
    string, or a tuple of them, one kernel each a call), from torch.profiler
    over reps calls after a warm-up: for a kernel shorter than its wrapper's
    host time, which an event time over back-to-back calls would measure
    instead. Each kernel's time is averaged over the launches the trace
    holds: on an H100 a trace of reps back-to-back calls has held only one
    in five of a kernel's launches (an average over reps then read a fifth of
    the event time, below the kernel's bytes bound). A trace that misses one
    of the kernels (it happened once, for K7 at a tiny shape) is taken again,
    up to ``attempts`` traces."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    matches = (match,) if isinstance(match, str) else match
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.key_averages():
            hits = [m for m in matches if m in e.key]
            if hits and e.count > 0 and _device_time_us(e) > 0:
                time_us, count = per_kernel.get(hits[0], (0.0, 0))
                per_kernel[hits[0]] = (time_us + _device_time_us(e), count + e.count)
        if len(per_kernel) == len(matches):
            return sum(t / n for t, n in per_kernel.values()) / 1e3
    check(False, f"no device time traced for kernels named {match} in {attempts} traces")


def library_times(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  grad=None, mask=None, pre=None) -> float:
    """Time of PyTorch's own attention on K1's head-major inputs: the
    library yardstick of the kernel table, used nowhere in the port. With
    ``grad``, the time of its backward: forward + backward less forward;
    with a ``[B, Nk]`` key-padding ``mask``, its boolean ``attn_mask``. With
    ``pre``, a plain step (q, k) -> (q_t, k_t) timed with every call (K5's
    and K6's transform): the composition of ``pre`` and PyTorch's attention,
    and with ``grad`` pre + forward + backward (grads of q_t, k_t and v)
    less the forward alone."""
    from torch.nn.functional import scaled_dot_product_attention

    attn_mask = None if mask is None else mask[:, None, None, :]

    def fwd(q_, k_, v_):
        return scaled_dot_product_attention(q_, k_, v_, attn_mask=attn_mask, scale=scale)

    def operands():
        return (*pre(q, k), v) if pre is not None else (q, k, v)

    if grad is None:
        return time_ms(lambda: fwd(*operands()))

    def fwd_bwd():
        fwd(*(t.detach().requires_grad_() for t in operands())).backward(grad)

    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in operands()]
        both = time_ms(fwd_bwd)
        fwd_only = time_ms(lambda: fwd(*leaves))
    return both - fwd_only


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS, exps: float = 0):
    """(least ms, what bounds it) for FLOPs at ``peak`` (the tensor cores' bf16
    rate unless given), HBM bytes and, for attention, its exponentials (one a
    score) at PEAK_EXP_RATE: the largest of the three."""
    return max((flops / peak * 1e3, "operations"), (nbytes / PEAK_HBM_BYTES * 1e3, "bytes"),
               (exps / PEAK_EXP_RATE * 1e3, "exp"), key=lambda t: t[0])


def errors(got: torch.Tensor, want: torch.Tensor):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def pair_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| per element in bf16 ulps at the magnitude of its (even,
    odd) pair of ``want`` (a rotation keeps the pair's norm, so an element
    near zero is measured against its partner's size)."""
    g, w = got.double(), want.double()
    mag = w.unflatten(-1, (-1, 2)).abs().amax(-1, keepdim=True).expand(*w.shape[:-1], -1, 2)
    unit = torch.exp2(torch.floor(torch.log2(mag.flatten(-2).clamp_min(2.0 ** -126))) - 7)
    return (g - w).abs() / unit


def gain(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return ((got * want).mean() / (want * want).mean()).item()


def k1_errors(got: torch.Tensor, want: torch.Tensor):
    """K1's max abs and rel error against its plain version, its abs limit
    (K1_ULPS bf16 ulps at the largest |want|) and its gain."""
    abs_err, rel_err = errors(got, want)
    return abs_err, rel_err, K1_ULPS * bf16_ulp(want.float().abs().max().item()), gain(got, want)


def check_k1(abs_err: float, atol: float, k1_gain: float, name: str = "K1") -> None:
    check(abs_err <= atol, f"{name} max abs err {abs_err} > {atol}")
    check(abs(k1_gain - 1) <= K1_GAIN_TOL, f"{name} gain {k1_gain} off 1 by > {K1_GAIN_TOL}")


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


class KernelTable:
    """One row per kernel of the JSON summary, from the B=8 shapes; rows
    under other keys (a kernel at another path's shapes) are printed only."""

    def __init__(self):
        self.rows = {}

    def add(self, key, shape, err, limit, ms, plain_ms, flops, nbytes, lib_ms=None,
            peak=PEAK_BF16_FLOPS, exps=0):
        bound_ms, bound_by = bound(flops, nbytes, peak, exps)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"kernel {key} {shape}: max_abs_err {err:.3e} ({limit}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms library {lib} bound {bound_ms:.4f} ms ({bound_by}, "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB, {exps / 1e9:.3f} G exp)")
        self.rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms)


def mlp_composition(x, w1_rows, b1, w2_rows):
    """K2's function as two cuBLAS GEMMs around PyTorch's exact GELU (a
    yardstick, used nowhere in the port): ``linear`` with the bias, then
    ``gelu``, then a product with fp32 output where the installed torch's
    ``out_dtype`` takes it, else bf16. Returns (out, the output's dtype)."""
    from torch.nn.functional import gelu, linear

    h = gelu(linear(x, w1_rows, b1), approximate="none")
    try:
        return torch.mm(h, w2_rows.t(), out_dtype=torch.float32), "fp32"
    except (TypeError, RuntimeError):
        return torch.mm(h, w2_rows.t()), "bf16"


def k2_check(dev, gen, table: KernelTable, key: str, rows: int, d: int, m: int,
             plain_reps: int = 20) -> None:
    """K2 on x [rows, d] and the MLP slices of linear1's and linear2's
    nn.Linear weights, against its plain version: the route it took (the
    Hopper kernel with x by TMA at every main-path shape), a second call
    bit-identical, and beside its time the two-GEMM cuBLAS composition's."""
    from lam_slide_tpu_torch.ops import fused_mlp as fm

    bf = torch.bfloat16
    x = _rand(gen, rows, d).to(dev, bf)
    w1_full = _rand(gen, 3 * d + m, d, scale=0.05).to(dev, bf)
    w2_full = _rand(gen, d, d + m, scale=0.05).to(dev, bf)
    b1 = _rand(gen, m, scale=0.1).to(dev, bf)
    args = (x, w1_full[3 * d:].t(), b1, w2_full[:, d:].t())
    before = (fm.launches, fm.wmma_launches, fm.cp_async_launches)
    got, want = fm.fused_mlp(*args), fm.reference_mlp(*args)
    torch.cuda.synchronize()
    launched = tuple(n - b for n, b in zip((fm.launches, fm.wmma_launches,
                                            fm.cp_async_launches), before))
    route = ("WMMA" if launched[1] else "Hopper, x by cp.async" if launched[2]
             else "Hopper, x by TMA")
    check(launched == (1, 0, 0), f"{key} launches {launched}: took the {route} route")
    check(got.shape == (rows, d) and got.dtype == torch.float32, f"{key} shape/dtype")
    check(torch.equal(got, fm.fused_mlp(*args)), f"{key}: a second call on the same inputs differs")
    abs_err, _ = errors(got, want)
    del got, want
    composition = (x, w1_full[3 * d:], b1, w2_full[:, d:])
    _, comp_dtype = mlp_composition(*composition)
    comp_ms = time_ms(lambda: mlp_composition(*composition), reps=plain_reps)
    table.add(key, f"x [{rows},{d}] w1 [{d},{m}] w2 [{m},{d}], route {route}, a second call "
              f"bit-identical; two-GEMM cuBLAS composition (linear + gelu + mm, {comp_dtype} out; "
              f"not one library call) {comp_ms:.4f} ms", abs_err,
              f"atol {K2_ATOL}", time_ms(lambda: fm.fused_mlp(*args)),
              time_ms(lambda: fm.reference_mlp(*args), reps=plain_reps),
              4 * rows * d * m, rows * d * (2 + 4) + 2 * d * m * 2 + m * 2)
    check(abs_err <= K2_ATOL, f"{key} max abs err {abs_err} > {K2_ATOL}")


def adaln_composition(x, h, gate, shift, scale):
    """K7's function as PyTorch ops (a yardstick, used nowhere in the port):
    the gated residual, ``F.layer_norm`` without affine parameters, the
    modulation."""
    from torch.nn.functional import layer_norm

    from lam_slide_tpu_torch.ops import fused_adaln as fad

    x_new = x + gate * h
    return x_new, fad.modulate(layer_norm(x_new, (x.shape[-1],), eps=1e-6), shift, scale)


def k7_check(dev, gen, table: KernelTable, key: str, batch: int, t: int, l: int, d: int,
             plain_reps: int = 20) -> None:
    """K7 on the DiT's [B, T, L, D] stream against its plain version: h the
    transposed temporal output, gate/shift/scale chunks of one [B, 1, 1, 6D]
    modulation; also the modulation without the residual."""
    from lam_slide_tpu_torch.ops import fused_adaln as fad

    bf = torch.bfloat16
    x7 = _rand(gen, batch, t, l, d, scale=3.0).to(dev, bf)
    h7 = _rand(gen, batch, l, t, d).to(dev, bf).transpose(1, 2)
    shift, scale, gate = _rand(gen, batch, 1, 1, 6 * d, scale=0.5).to(dev, bf).chunk(6, -1)[:3]
    args7 = (x7, h7, gate, shift, scale)
    (x_new, y), (want_x, want_y) = (fad.residual_adaln_modulate(*args7),
                                    fad.reference_residual_adaln_modulate(*args7))
    torch.cuda.synchronize()
    check(torch.equal(x_new, want_x), f"{key} x_new is not bit-identical to the plain version")
    abs_err, _ = errors(y, want_y)
    atol = K7_ULPS * bf16_ulp(want_y.float().abs().max().item())
    del x_new, y, want_x, want_y
    y0, want_y0 = fad.adaln_modulate(x7, shift, scale), fad.reference_adaln_modulate(
        x7, shift, scale)
    err0, _ = errors(y0, want_y0)
    atol0 = K7_ULPS * bf16_ulp(want_y0.float().abs().max().item())
    del y0, want_y0
    event_ms = time_ms(lambda: fad.residual_adaln_modulate(*args7))
    comp_ms = time_ms(lambda: adaln_composition(*args7), reps=plain_reps)
    table.add(key, f"x/h [{batch},{t},{l},{d}] (x_new bit-identical; y without residual "
              f"{err0:.3e}); time: the kernel's device time (profiler), the wrapper's event "
              f"time {event_ms:.4f} ms; library: none (F.layer_norm + modulate composition "
              f"{comp_ms:.4f} ms)", abs_err, f"atol {atol:.3e} = {K7_ULPS} bf16 ulp at max |y|",
              device_ms(lambda: fad.residual_adaln_modulate(*args7), "adaln_kernel"),
              time_ms(lambda: fad.reference_residual_adaln_modulate(*args7), reps=plain_reps),
              0, 4 * batch * t * l * d * 2 + 3 * batch * d * 2)
    check(abs_err <= atol, f"{key} y max abs err {abs_err} > {atol}")
    check(err0 <= atol0, f"{key} (no residual) y max abs err {err0} > {atol0}")


def k5_counts():
    """K5's counters and K1's, in one tuple: K5 calls, transform launches,
    sm90 forwards, of them on cp.async; K1 calls, K1 sm90 forwards."""
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr

    return (fnr.launches, fnr.transform_launches, fnr.sm90_launches, fnr.sm90_cp_async_launches,
            fa.launches, fa.sm90_launches)


def transform_check(table: KernelTable, args5) -> None:
    """The transform kernel on K5's raw q/k views against pre_transform:
    contiguous outputs, the pair-ulp limits, its time and its bytes bound
    (q and k read and written once, the tables read once)."""
    from lam_slide_tpu_torch.ops import flash_normrope as fnr

    q, k, _, qs, ks, cos, sin = args5
    tr = (q, k, qs, ks, cos, sin)
    before = fnr.transform_launches
    got, want = fnr.qk_normrope(*tr), fnr.pre_transform(*tr)
    torch.cuda.synchronize()
    check(fnr.transform_launches == before + 1, "the transform kernel did not launch once")
    check(all(t.is_contiguous() and t.shape == w.shape for t, w in zip(got, want)),
          "q_t/k_t are not contiguous head-major")
    ulps = torch.cat([pair_ulps(t, w).flatten() for t, w in zip(got, want)])
    worst, differ = ulps.max().item(), int((ulps > 0).sum())
    share = differ / ulps.numel()
    allowed = max(2, int(TRANSFORM_DIFF_SHARE * ulps.numel()))
    abs_err = max(errors(t, w)[0] for t, w in zip(got, want))
    del got, want, ulps
    elems = 2 * q.numel()
    event_ms = time_ms(lambda: fnr.qk_normrope(*tr))
    table.add("K5 transform", f"raw q/k {list(q.shape)} strided views -> contiguous q_t/k_t; "
              f"max {worst:.3f} bf16 ulps at the pair's magnitude, {differ} of {elems} "
              f"elements differ ({share:.3e}); time: the kernel's device time (profiler), the "
              f"wrapper's event time {event_ms:.4f} ms", abs_err,
              f"{TRANSFORM_PAIR_ULPS} pair ulps on at most {allowed} elements",
              device_ms(lambda: fnr.qk_normrope(*tr), "qk_normrope_kernel"),
              time_ms(lambda: fnr.pre_transform(*tr)),
              8 * elems, 2 * elems * 2 + 2 * cos.numel() * 4 + 2 * qs.numel() * 4,
              peak=PEAK_FP32_FLOPS)
    check(worst <= TRANSFORM_PAIR_ULPS, f"transform max pair ulps {worst} > {TRANSFORM_PAIR_ULPS}")
    check(differ <= allowed, f"transform: {differ} elements differ, more than {allowed}")


def kernel_checks(dev, gen, table: KernelTable) -> None:
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb

    d, m = HIDDEN, HIDDEN * MLP_RATIO
    bf = torch.bfloat16
    for batch in (2, 8):
        bp, rows = batch * L, batch * L * T  # temporal batch B*L; positions B*T*L
        attn_flops, attn_bytes = 4 * bp * T * T * d, 4 * bp * T * d * 2
        exps16, exps3 = bp * HEADS * T * T, bp * WIDE_HEADS * T * T

        # K1 on head-major strided views of one qkv buffer
        dh = d // HEADS
        qkv = _rand(gen, bp, T, 3 * d).to(dev, bf)
        q, k, v = (t.transpose(1, 2) for t in qkv.view(bp, T, 3, HEADS, dh).unbind(2))
        got, want = fa.flash_attention(q, k, v), fa.reference_attention(q, k, v)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == bf, "K1 shape/dtype")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        table.add("K1", f"q/k/v [{bp},{HEADS},{T},{dh}] strided views, gain {k1_gain:.7f}",
                  abs_err, f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fa.flash_attention(q, k, v)),
                  time_ms(lambda: fa.reference_attention(q, k, v)), attn_flops, attn_bytes,
                  library_times(q, k, v, dh ** -0.5), exps=exps16)
        check_k1(abs_err, atol, k1_gain)

        # K3: the packed entry on [B*L, T, H*dh] views of the same buffer
        qp, kp, vp = qkv.chunk(3, dim=-1)
        got = fa.flash_attention_packed(qp, kp, vp, HEADS)
        want = fa.reference_attention_packed(qp, kp, vp, HEADS)
        torch.cuda.synchronize()
        check(got.shape == qp.shape and got.is_contiguous(), "K3 shape/layout")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        table.add("K3", f"packed q/k/v [{bp},{T},{d}] views, gain {k1_gain:.7f}", abs_err,
                  f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fa.flash_attention_packed(qp, kp, vp, HEADS)),
                  time_ms(lambda: fa.reference_attention_packed(qp, kp, vp, HEADS)),
                  attn_flops, attn_bytes, library_times(q, k, v, dh ** -0.5), exps=exps16)
        check_k1(abs_err, atol, k1_gain, "K3")

        # K1's cp.async route: dh 20 (TMA needs dh % 8 == 0), q/k/v head-major
        # views of one packed buffer at the 4AA temporal shape
        qkv20 = _rand(gen, bp, T, 3 * HEADS * 20).to(dev, bf)
        q20, k20, v20 = (t.transpose(1, 2) for t in qkv20.view(bp, T, 3, HEADS, 20).unbind(2))
        check(not fa.sm90_tma_ok(q20, k20, v20), "dh 20 views must take the cp.async route")
        before = fa.sm90_cp_async_launches
        got, want = fa.flash_attention(q20, k20, v20), fa.reference_attention(q20, k20, v20)
        torch.cuda.synchronize()
        check(fa.sm90_cp_async_launches == before + 1, "K1 dh 20 did not take the cp.async route")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        table.add("K1 cp.async", f"q/k/v [{bp},{HEADS},{T},20] strided views, cp.async route, "
                  f"gain {k1_gain:.7f}", abs_err,
                  f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fa.flash_attention(q20, k20, v20)),
                  time_ms(lambda: fa.reference_attention(q20, k20, v20)),
                  4 * bp * T * T * HEADS * 20, 4 * bp * T * HEADS * 20 * 2,
                  library_times(q20, k20, v20, 20 ** -0.5), exps=exps16)
        check_k1(abs_err, atol, k1_gain, "K1 cp.async")
        del qkv20, q20, k20, v20

        # K5 on raw strided views of a 3 x 128 qkv buffer: the transform
        # kernel writes q_t/k_t once, then the redesigned forward runs on
        # them and v (TMA route); nothing counts under K1
        wdh = d // WIDE_HEADS
        qkv5 = _rand(gen, bp, T, 3, WIDE_HEADS, wdh, scale=2.0).to(dev, bf)
        q5, k5, v5 = (t.transpose(1, 2) for t in qkv5.unbind(2))
        qs, ks = ((1 + 0.2 * _rand(gen, wdh)).to(dev) for _ in range(2))
        cos, sin = rope_cos_sin(T, wdh, device=dev)
        args5 = (q5, k5, v5, qs, ks, cos, sin)
        transform_check(table, args5)
        before = k5_counts()
        got, want = fnr.flash_attention_normrope(*args5), fnr.reference_attention_normrope(*args5)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(k5_counts(), before))
        check(launched == (1, 1, 1, 0, 0, 0), f"K5 launches {launched} (K5, transform, sm90, "
              f"cp.async, K1, K1 sm90): not one transform and one sm90 forward by TMA")
        check(got.shape == want.shape and got.dtype == bf, "K5 shape/dtype")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        comp_ms = library_times(q5, k5, v5, wdh ** -0.5,
                                pre=lambda q_, k_: fnr.pre_transform(q_, k_, qs, ks, cos, sin))
        dev_ms = device_ms(lambda: fnr.flash_attention_normrope(*args5),
                           ("qk_normrope_kernel", "flash_fwd_sm90_kernel"))
        table.add("K5", f"raw q/k/v [{bp},{WIDE_HEADS},{T},{wdh}] strided views, transform "
                  f"kernel + sm90 forward (TMA), gain {k1_gain:.7f}, device time of the two "
                  f"kernels {dev_ms:.4f} ms; library none (composition: plain pre_transform + "
                  f"SDPA: {comp_ms:.4f} ms)", abs_err,
                  f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fnr.flash_attention_normrope(*args5)),
                  time_ms(lambda: fnr.reference_attention_normrope(*args5)),
                  attn_flops, attn_bytes + 2 * T * wdh // 2 * 4, exps=exps3)
        check_k1(abs_err, atol, k1_gain, "K5")
        del got, want

        k2_check(dev, gen, table, "K2", rows, d, m)
        k7_check(dev, gen, table, "K7", batch, T, L, d)

        # K8 on [B*T, L, D] frames at both head splits: the Hopper route
        frames = batch * T
        x8 = _rand(gen, frames, L, d).to(dev, bf)
        w18 = _rand(gen, 3 * d + m, d, scale=d ** -0.5).to(dev, bf)
        b18 = _rand(gen, 3 * d + m, scale=0.1).to(dev, bf)
        w28 = _rand(gen, d, d + m, scale=(d + m) ** -0.5).to(dev, bf)
        b28 = _rand(gen, d, scale=0.1).to(dev, bf)
        a8 = _rand(gen, rows, d + m).to(dev, bf)  # [attn | gelu] for the GEMM yardstick
        for heads in (HEADS, WIDE_HEADS):
            key = "K8" if heads == HEADS else "K8 3x128"
            args8 = k8_args(dev, gen, x8, w18, b18, w28, b28, heads)
            abs_err, rel_err, note = k8_check(key, args8, "sm90")
            gemm_ms = time_ms(lambda: (torch.matmul(x8, w18.t()), torch.matmul(a8, w28.t())))
            dev_ms = device_ms(lambda: fsb.fused_spatial_block(*args8), "spatial_sm90_kernel")
            table.add(key, f"x [{frames},{L},{d}] heads {heads} x {d // heads}, Hopper route, "
                      f"{note}, device time {dev_ms:.4f} ms; library none (the two bare cuBLAS "
                      f"GEMMs x @ w1^T and [attn|gelu] @ w2^T, the kernel's floor: "
                      f"{gemm_ms:.4f} ms)", abs_err, f"rel tol {K8_REL_TOL}",
                      time_ms(lambda: fsb.fused_spatial_block(*args8)),
                      time_ms(lambda: fsb.reference_spatial_block(*args8)),
                      2 * rows * (d * (3 * d + m) + (d + m) * d),
                      2 * rows * d * 2 + ((3 * d + m) * d + d * (d + m)) * 2, gemm_ms)
    k8_width_checks(dev, gen, table)
    k8_tp_checks(dev, gen, table)
    tp_rank_kernel_checks(dev, gen, table)
    tp_rank_f32_kernel_checks(dev, table)


def k8_args(dev, gen, x, w1, b1, w2, b2, heads):
    """K8's arguments for x [N, L, D] and nn.Linear weights at ``heads`` heads:
    QK-norm scales around 1 and the RoPE tables of the L positions."""
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin

    dh = x.shape[-1] // heads
    qs, ks = ((1 + 0.2 * _rand(gen, dh)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(x.shape[1], dh, device=dev)
    return x, w1, b1, qs, ks, w2, b2, cos, sin, heads, dh ** -0.5


def k8_check(key: str, args8, route: str):
    """K8 against its plain version on ``args8``: one launch on ``route``
    ("sm90": the Hopper kernel; "wmma": the WMMA route), the shape and dtype,
    a second call bit-identical, the error within K8_REL_TOL. Returns (max
    abs err, rel err, a note)."""
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb

    before = (fsb.launches, fsb.wmma_launches)
    got, want = fsb.fused_spatial_block(*args8), fsb.reference_spatial_block(*args8)
    again = fsb.fused_spatial_block(*args8)
    torch.cuda.synchronize()
    launched = (fsb.launches - before[0], fsb.wmma_launches - before[1])
    check(launched == ((2, 0) if route == "sm90" else (2, 2)),
          f"{key} launches {launched} (both routes, WMMA) for two calls: not the {route} route")
    check(got.shape == args8[0].shape and got.dtype == torch.bfloat16, f"{key} shape/dtype")
    check(torch.equal(got, again), f"{key}: a second call on the same inputs differs")
    abs_err, rel_err = errors(got, want)
    check(rel_err <= K8_REL_TOL, f"{key} rel err {rel_err} > {K8_REL_TOL}")
    return abs_err, rel_err, f"rel {rel_err:.3e}, a second call bit-identical"


def k8_width_checks(dev, gen, table: KernelTable) -> None:
    """K8 at the widths and frame lengths the main paths do not run: the 4AA
    widths at L = 1, 3 and 8 (tiles of 64, 63 and 64 rows: whole frames)
    at both head splits, the NBA DiT's (hidden 256, 16 x dh 16) and the
    pedestrian DiT's (hidden 128, 4 x dh 32) at two frame lengths each, all
    on the Hopper route; and the WMMA route at the tiny test registries'
    width (hidden 32, 4 x dh 8), whose row of the summary this is."""
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb

    bf = torch.bfloat16
    cases = [(4000 // l, l, HIDDEN, HEADS) for l in (1, 3, 8)]
    cases += [(4000 // l, l, HIDDEN, WIDE_HEADS) for l in (1, 3, 8)]
    cases += [(999, 5, 256, 16), (2000, 2, 256, 16), (1001, 7, 128, 4), (2000, 4, 128, 4)]
    for n, l, d, heads in cases + [(2000, 2, 32, 4)]:
        m = 2 * d
        x = _rand(gen, n, l, d).to(dev, bf)
        w1 = _rand(gen, 3 * d + m, d, scale=d ** -0.5).to(dev, bf)
        b1 = _rand(gen, 3 * d + m, scale=0.1).to(dev, bf)
        w2 = _rand(gen, d, d + m, scale=(d + m) ** -0.5).to(dev, bf)
        b2 = _rand(gen, d, scale=0.1).to(dev, bf)
        args8 = k8_args(dev, gen, x, w1, b1, w2, b2, heads)
        route = "wmma" if d == 32 else "sm90"
        key = "K8 wmma" if route == "wmma" else f"K8 [{n},{l},{d}] {heads}x{d // heads}"
        abs_err, rel_err, note = k8_check(key, args8, route)
        rows = n * l
        table.add(key, f"x [{n},{l},{d}] heads {heads} x {d // heads}, {route} route, {note}",
                  abs_err, f"rel tol {K8_REL_TOL}",
                  time_ms(lambda: fsb.fused_spatial_block(*args8)),
                  time_ms(lambda: fsb.reference_spatial_block(*args8)),
                  2 * rows * (d * (3 * d + m) + (d + m) * d),
                  2 * rows * d * 2 + ((3 * d + m) * d + d * (d + m)) * 2)


# K8's per-rank instance at the ranks of phase 20 and below a Hopper head
# group: (key, frames, L, D, heads, tp, fp32, route). bf16 at the 4AA train
# step's [16000, 2, 384] on the Hopper kernel at each split of TP_SPLITS,
# then on the WMMA kernel at 16 x 24 tp 8 (Da 48 under a group of 96) and at
# the pedestrian (tp 4) and NBA (tp 8) DiTs' test-pass frames (Da 32 under
# 64); fp32 (TF32 off) on the outer-product kernel at the TP_SPLITS ranks
# and on the dot-product kernel at phase 20's NBA fp32 forward rank (tp 8:
# Da 32 under the D 256 instance's head group of 64), the shape whose
# launches the summary's "K8 fp32 tp partial dot" row counts.
K8_TP_CASES = (
    ("K8 tp partial", TRAIN_BATCH * T, L, HIDDEN, HEADS, 2, False, "sm90"),
    (f"K8 tp partial {HEADS}x24 tp4", TRAIN_BATCH * T, L, HIDDEN, HEADS, 4, False, "sm90"),
    (f"K8 tp partial {WIDE_HEADS}x128 tp3", TRAIN_BATCH * T, L, HIDDEN, WIDE_HEADS, 3, False,
     "sm90"),
    ("K8 wmma tp partial", TRAIN_BATCH * T, L, HIDDEN, HEADS, 8, False, "wmma"),
    ("K8 wmma tp partial pedestrian tp4", 256 * 20, 2, 128, 4, 4, False, "wmma"),
    ("K8 wmma tp partial nba tp8", 1024 * 20, 8, 256, 16, 8, False, "wmma"),
    ("K8 fp32 tp partial", TRAIN_BATCH * T, L, HIDDEN, HEADS, 2, True, "tiled"),
    (f"K8 fp32 tp partial {HEADS}x24 tp4", TRAIN_BATCH * T, L, HIDDEN, HEADS, 4, True, "tiled"),
    (f"K8 fp32 tp partial {WIDE_HEADS}x128 tp3", TRAIN_BATCH * T, L, HIDDEN, WIDE_HEADS, 3,
     True, "tiled"),
    ("K8 fp32 tp partial dot", 1024 * 20, 8, 256, 16, 8, True, "dot"),
)


def k8_tp_checks(dev, gen, table: KernelTable) -> None:
    """K8's per-rank instance, a tensor-parallel rank's partial (Da = D/tp
    attention columns of H/tp heads, Mr = M/tp MLP columns, linear2's fp32
    product without b2), at K8_TP_CASES: the last rank's slice against the
    plain partial (K8_REL_TOL in bf16; PEP_F32_REL_TOL["K8 fp32"] in fp32,
    TF32 off) on the case's route (its counter and tp_partial_launches move
    once a call), a second call bit-identical, on the outer-product route
    bit-identical to the dot-product one; the ranks' partials summed, rounded and + b2 against
    the whole block's kernel within the same limit; the kernel's time (and
    on the Hopper route its device time), bound, plain time and the two
    bare cuBLAS GEMMs (SGEMMs in fp32) of the rank's shapes. The rows "K8
    tp partial" (16 x 24 tp 2), "K8 wmma tp partial" (tp 8), "K8 fp32 tp
    partial" (tp 2) and "K8 fp32 tp partial dot" (NBA tp 8) are the
    summary's, each at the shape whose launches phase 20 counts."""
    from torch.nn.functional import linear

    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
    from lam_slide_tpu_torch.parallel import tp

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    names = ("launches", "tp_partial_launches", "wmma_launches", "f32_tiled_launches",
             "f32_dot_launches")
    weights = {}
    for key, frames, l, d, heads, size, fp32, route in K8_TP_CASES:
        dtype = torch.float32 if fp32 else torch.bfloat16
        m = MLP_RATIO * d
        if (frames, l, d) not in weights:
            weights = {(frames, l, d): (
                _rand(gen, frames, l, d), _rand(gen, 3 * d + m, d, scale=d ** -0.5),
                _rand(gen, 3 * d + m, scale=0.1), _rand(gen, d, d + m, scale=(d + m) ** -0.5),
                _rand(gen, d, scale=0.1))}
        x, w1, b1, w2, b2 = (t.to(dev, dtype) for t in weights[(frames, l, d)])
        split = f"{heads}x{d // heads}"
        whole = k8_args(dev, gen, x, w1, b1, w2, b2, heads)
        da, mr, rows = d // size, m // size, frames * l
        kw = {"attn_width": da, "partial": True}

        def rank_args(r, whole=whole, size=size, d=d, m=m, heads=heads):
            return (whole[0], tp.slice_linear1(whole[1], d, m, size, r),
                    tp.slice_linear1(whole[2], d, m, size, r), whole[3], whole[4],
                    tp.slice_linear2(whole[5], d, m, size, r), None, whole[7], whole[8],
                    heads // size, whole[10])

        ranks = [rank_args(r) for r in range(size)]
        last = ranks[-1]
        before = [getattr(fsb, name) for name in names]
        parts = [fsb.fused_spatial_block(*a, **kw) for a in ranks]
        again = fsb.fused_spatial_block(*last, **kw)
        whole_out = fsb.fused_spatial_block(*whole)
        torch.cuda.synchronize()
        launched = tuple(getattr(fsb, name) - b for name, b in zip(names, before))
        # the whole block's own route: the Hopper kernel in bf16, the
        # outer-product kernel in fp32 at these widths
        want_launched = (size + 2, size + 1, (size + 1) * (route == "wmma"),
                         (size + 1) * (route == "tiled") + fp32, (size + 1) * (route == "dot"))
        check(launched == want_launched, f"{key}: launches {launched} of {names} for {size} "
              f"partials, a repeat and the whole block, not {want_launched}")
        want = fsb.reference_spatial_block(*last, **kw)
        got = parts[-1]
        check(got.dtype == torch.float32 and got.shape == x.shape, f"{key} shape/dtype")
        check(torch.equal(got, again), f"{key}: a second call on the same inputs differs")
        note = ""
        if fp32:
            plan = fsb.f32_plan(frames, l, d, mr, heads // size, da)
            note = (f"; plan group {plan.group}, {plan.rows} rows a block, {plan.blocks} "
                    f"blocks, {plan.smem} B")
        if route == "tiled":
            check(torch.equal(got, fsb._launch_f32_dot(*last, **kw)),
                  f"{key}: the outer- and dot-product partials differ")
            note += ", bit-identical to the dot-product route"
        tol = PEP_F32_REL_TOL["K8 fp32"] if fp32 else K8_REL_TOL
        abs_err, rel_err = errors(got, want)
        summed = sum(parts[1:], parts[0]).to(dtype) + b2
        _, sum_rel = errors(summed, whole_out)
        check(rel_err <= tol, f"{key} rel err {rel_err} > {tol}")
        check(sum_rel <= tol, f"{key}: the summed partials vs the whole block, rel err "
              f"{sum_rel} > {tol}")
        del parts, again, whole_out, want, got, summed
        xr, w1r, w2r = x.view(rows, d), last[1], last[5]
        a8 = torch.empty(rows, da + mr, device=dev, dtype=dtype)  # [attn | gelu] of the rank
        gemm_ms = time_ms(lambda: (linear(xr, w1r), linear(a8, w2r)))
        if route == "sm90":
            dev_ms = device_ms(lambda: fsb.fused_spatial_block(*last, **kw), "spatial_sm90_kernel")
            note += f", device time {dev_ms:.4f} ms"
        size_b = 4 if fp32 else 2
        table.add(key, f"x [{frames},{l},{d}] {split} at tp {size}: rank {size - 1}'s "
                  f"{heads // size} heads (Da {da}) and {mr} MLP columns, w1 {list(w1r.shape)}, "
                  f"w2 {list(w2r.shape)}, {'fp32' if fp32 else 'bf16'}, fp32 partial; {route} "
                  f"route, rel {rel_err:.3e}, a second call bit-identical{note}, the {size} "
                  f"partials summed + b2 vs the whole block's kernel rel {sum_rel:.3e}; library "
                  f"none (the two bare cuBLAS {'SGEMMs' if fp32 else 'GEMMs'} of the rank, "
                  f"x @ w1^T and [attn|gelu] @ w2^T: {gemm_ms:.4f} ms)", abs_err,
                  f"rel tol {tol}", time_ms(lambda: fsb.fused_spatial_block(*last, **kw)),
                  time_ms(lambda: fsb.reference_spatial_block(*last, **kw), reps=5),
                  2 * rows * (d * (3 * da + mr) + (da + mr) * d),
                  rows * d * size_b + rows * d * 4 + ((3 * da + mr) * (d + 1) + d * (da + mr))
                  * size_b, gemm_ms, peak=PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
        del ranks, last, whole, a8, x, w1, b1, w2, b2
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# (key, module kernel, sequences, n, rank heads, dh): a tensor-parallel
# rank's attention on its own views of linear1's output (q/k normed and
# rotated as LatentDiT passes them, v a strided view), at the train steps
# of phase 20: 4AA B=16 (B*L = 32 sequences of T=1000) at 16 x 24 tp 2 and
# tp 4, 3 x 128 tp 3 (K5 on raw views), MD17 B=64 tp 2 (its spatial axis,
# B*T = 1920 sequences of L=192, and its temporal axis, B*L = 12288 of T=30)
TP_RANK_ATTENTION = (("K3 tp 16x24 tp2", "K3", 32, T, 8, 24),
                     ("K3 tp 16x24 tp4", "K3", 32, T, 4, 24),
                     ("K5 tp 3x128 tp3", "K5", 32, T, 1, 128),
                     ("K3 tp md17 tp2", "K3", 1920, 192, 8, 16),
                     ("K9 tp md17 tp2", "K9", 12288, MD17_T, 8, 16))
# (key, rows, d, d_mid): K2 at a rank's MLP width, 4AA's temporal rows
# (B*L*T) at M/tp for tp 2, 4 and 3, MD17's (B*T*L at the spatial axis) at tp 2
TP_RANK_MLP = (("K2 tp 16x24 tp2", TRAIN_BATCH * L * T, HIDDEN, 384),
               ("K2 tp 16x24 tp4", TRAIN_BATCH * L * T, HIDDEN, 192),
               ("K2 tp 3x128 tp3", TRAIN_BATCH * L * T, HIDDEN, 256),
               ("K2 tp md17 tp2", MD17_BATCH * MD17_T * 192, 256, 256))


def tp_rank_kernel_checks(dev, gen, table: KernelTable) -> None:
    """The kernels a tensor-parallel rank runs besides K8's partial, at its
    widths (TP_RANK_ATTENTION, TP_RANK_MLP): each against its plain version
    (K1's ulp and gain limits, K2_ATOL), on the TMA route (0 cp.async
    launches; K2 by k2_check), K9 with its head groups at 8 heads."""
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr
    from lam_slide_tpu_torch.ops import short_attention as tsa

    bf = torch.bfloat16
    for key, kernel, seqs, n, heads, dh in TP_RANK_ATTENTION:
        da = heads * dh
        g = torch.Generator(device=dev).manual_seed(SEED + 24)
        qkv = torch.randn(seqs, n, 3 * da, generator=g, device=dev).to(bf)
        if kernel == "K5":
            q, k, v = (t.transpose(1, 2) for t in qkv.view(seqs, n, 3, heads, dh).unbind(2))
            qs, ks = ((1 + 0.2 * _rand(gen, dh)).to(dev) for _ in range(2))
            cos, sin = rope_cos_sin(n, dh, device=dev)
            args = (q, k, v, qs, ks, cos, sin)
            fn, plain = fnr.flash_attention_normrope, fnr.reference_attention_normrope
            note = f"raw head-major views [{seqs},{heads},{n},{dh}] of qkv [{seqs},{n},{3 * da}]"
        else:
            q, k = (qkv[..., i * da:(i + 1) * da].contiguous() for i in range(2))
            v = qkv[..., 2 * da:]
            args = (q, k, v, heads)
            fn, plain = ((fa.flash_attention_packed, fa.reference_attention_packed) if kernel == "K3"
                         else (tsa.short_attention, tsa.reference_short_attention))
            note = f"packed q/k [{seqs},{n},{da}], v a view of qkv [{seqs},{n},{3 * da}]"
            if kernel == "K9":
                note += (f", head groups fwd {tsa.fwd_heads_per_block(n, heads, dh)} / bwd "
                         f"{tsa.bwd_heads_per_block(n, heads, dh)} of {heads}")
        cp_before = (fa.sm90_cp_async_launches, fnr.sm90_cp_async_launches)
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        cp_async = (fa.sm90_cp_async_launches - cp_before[0],
                    fnr.sm90_cp_async_launches - cp_before[1])
        check(cp_async == (0, 0), f"{key}: cp.async launches {cp_async}")
        check(torch.equal(got, fn(*args)), f"{key}: a second call on the same inputs differs")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        check_k1(abs_err, atol, k1_gain, key)
        del got, want
        table.add(key, f"{note}, {heads} x {dh}, TMA route, gain {k1_gain:.7f}, a second call "
                  f"bit-identical", abs_err, f"atol {atol:.3e} = {K1_ULPS} bf16 ulps",
                  time_ms(lambda: fn(*args), reps=5), time_ms(lambda: plain(*args), reps=2),
                  4 * seqs * heads * n * n * dh, 4 * seqs * n * da * 2,
                  exps=seqs * heads * n * n)
        del qkv, q, k, v, args
        torch.cuda.empty_cache()
    for key, rows, d, d_mid in TP_RANK_MLP:
        k2_check(dev, gen, table, key, rows, d, d_mid, plain_reps=3)
        torch.cuda.empty_cache()


# (key, kind, sequences, heads, n, dh): a tensor-parallel rank's fp32
# attention on its own heads at the fp32 train steps of phase 20: the 4AA
# temporal axis (B*L = 32 sequences of T=1000) at 16 x 24 tp 2 and tp 4 (K3
# through K1's fp32 kernel, K4-fp32 backward) and 3 x 128 tp 3 (one head:
# K5-fp32, K6-fp32); MD17 B=64 at 16 x 16 tp 2, its spatial axis (B*T =
# 1920 sequences of L=192; K3, K4) and its temporal one (B*L = 12288 of
# T=30; K9-fp32 forward and backward), and at 2 x 128 tp 2 (one head) its
# spatial axis (K5-fp32, K6-fp32)
TP_RANK_F32_ATTENTION = (
    ("tp 16x24 tp2", "K1", TRAIN_BATCH * L, 8, T, 24),
    ("tp 16x24 tp4", "K1", TRAIN_BATCH * L, 4, T, 24),
    ("tp 3x128 tp3", "K5", TRAIN_BATCH * L, 1, T, 128),
    ("tp md17 tp2", "K1", MD17_BATCH * MD17_T, 8, 192, 16),
    ("tp md17 tp2", "K9", MD17_BATCH * 192, 8, MD17_T, 16),
    ("tp md17 2x128 tp2", "K5", MD17_BATCH * MD17_T, 1, 192, 128),
)
# (key, rows, d, d_mid): K2-fp32 at a rank's MLP width, as TP_RANK_MLP
TP_RANK_F32_MLP = tuple((key.replace("K2 tp", "K2 fp32 tp"), rows, d, d_mid)
                        for key, rows, d, d_mid in TP_RANK_MLP)


def tp_rank_f32_kernel_checks(dev, table: KernelTable) -> None:
    """The fp32 kernels a tensor-parallel rank runs besides K8's partial, at
    its widths (TP_RANK_F32_ATTENTION, TP_RANK_F32_MLP), against their
    plain versions with TF32 off: the forward (K3 through K1-fp32, K5-fp32,
    K9-fp32) within K1_F32_REL_TOL, K5_F32_REL_TOL or F32_REL_TOL["K9
    fp32"], the backward (K4-fp32, K6-fp32, K9-fp32's) within
    K4_F32_REL_TOL, K6_F32_REL_TOL or K9_F32_GRAD_REL_TOL per grad; K2-fp32
    within F32_REL_TOL["K2 fp32"] on the route its plan gives (printed: the
    dot-product kernel at 3 x 128 tp 3's d_mid 256). Each launches its fp32
    kernel, repeats bit for bit, and is timed beside its plain version, its
    bound and SDPA's fp32 call (K2: the two-GEMM composition)."""
    from torch.nn.functional import gelu, linear

    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr
    from lam_slide_tpu_torch.ops import fused_mlp as fm
    from lam_slide_tpu_torch.ops import short_attention as tsa

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    for tag, kind, b, h, n, dh in TP_RANK_F32_ATTENTION:
        scale = dh ** -0.5
        g = torch.randn(b, h, n, dh, generator=gen, device=dev)
        if kind == "K9":
            qkv = torch.randn(b, n, 3 * h * dh, generator=gen, device=dev)
            q, k, v = qkv.chunk(3, dim=-1)
            g = g.transpose(1, 2).reshape(b, n, h * dh)
            fwd = (lambda: tsa.short_attention(q, k, v, h),
                   lambda: tsa.reference_short_attention(q, k, v, h, scale))
            bwd = (lambda: tsa.short_attention_backward(q, k, v, g, h, scale),
                   lambda: tsa.reference_short_backward(q, k, v, g, h, scale))
            counts = (lambda: (tsa.fp32_launches, tsa.bwd_fp32_launches))
            want_counts = ((1, 0), (0, 1))
            heads_view = [t.unflatten(-1, (h, dh)).transpose(1, 2) for t in (q, k, v, g)]
            lib = (lambda: library_times(*heads_view[:3], scale),
                   lambda: library_times(*heads_view[:3], scale, grad=heads_view[3]))
            tols = (F32_REL_TOL["K9 fp32"], K9_F32_GRAD_REL_TOL)
            keys = (f"K9 fp32 {tag}", f"K9 fp32 bwd {tag}")
            shape = f"packed q/k/v [{b},{n},{h * dh}] views of one qkv buffer"
        else:
            x = dh128_inputs(dev, (tag, kind, b, h, n, n, dh, True, False, True), SEED + 26)
            q, k, v = x["q"], x["k"], x["v"]
            if kind == "K1":
                out, lse = fa._forward(q, k, v, scale, with_lse=True)
                args = (q, k, v, out, lse, g, scale)
                fwd = (lambda: fa._forward(q, k, v, scale, False)[0],
                       lambda: fa.reference_attention(q, k, v, scale))
                bwd = (lambda: fa.flash_attention_backward(*args),
                       lambda: fa.reference_flash_backward(*args))
                counts = (lambda: (fa.fp32_launches, fa.bwd_fp32_launches))
                want_counts = ((1, 0), (0, k4_f32_kernels(dh, n, n)))
                lib = (lambda: library_times(q, k, v, scale),
                       lambda: library_times(q, k, v, scale, grad=g))
                tols = (K1_F32_REL_TOL, K4_F32_REL_TOL)
                keys = (f"K3 fp32 {tag}", f"K4 fp32 {tag}")
            else:
                tr = (x["qs"], x["ks"], x["cos"], x["sin"])
                out, lse = fnr._forward(q, k, v, *tr, scale, with_lse=True)
                args = (q, k, v, *tr, out, lse, g, scale)
                fwd = (lambda: fnr.flash_attention_normrope(q, k, v, *tr),
                       lambda: fnr.reference_attention_normrope(q, k, v, *tr))
                bwd = (lambda: fnr.flash_attention_normrope_backward(*args),
                       lambda: fnr.reference_normrope_backward(*args))
                counts = (lambda: (fnr.fp32_launches, fnr.bwd_fp32_launches))
                want_counts = ((1, 0), (0, k4_f32_kernels(dh, n, n)))

                def pre(q_, k_):
                    return fnr.pre_transform(q_, k_, *tr)

                lib = (lambda: library_times(q, k, v, scale, pre=pre),
                       lambda: library_times(q, k, v, scale, grad=g, pre=pre))
                tols = (K5_F32_REL_TOL, K6_F32_REL_TOL)
                keys = (f"K5 fp32 {tag}", f"K6 fp32 {tag}")
            shape = f"head-major q/k/v [{b},{h},{n},{dh}] strided views of packed buffers"
        for which, ((kernel, plain), want_launched, tol, key) in enumerate(
                zip((fwd, bwd), want_counts, tols, keys)):
            before = counts()
            got = kernel()
            launched = tuple(a - c for a, c in zip(counts(), before))
            again = kernel()
            want = plain()
            check(launched == want_launched, f"{key}: launches {launched} != {want_launched}")
            check(_bit_identical(got if which else [got], again if which else [again]),
                  f"{key}: a second call differs")
            errs = _grad_errors(got, want) if which else [(*errors(got, want), 0.0)]
            worst = max(e[1] for e in errs)
            check(worst <= tol, f"{key} rel err {worst} > {tol}")
            what = "forward" if not which else "backward, grads " + ", ".join(
                f"{nm} rel {r:.3e}" for nm, (_, r, _) in zip(("dq", "dk", "dv"), errs))
            del got, again, want
            flops = (4 if not which else 10) * b * h * n * n * dh
            nbytes = 4 * (4 if not which else 8) * b * h * n * dh
            table.add(key, f"{shape}, {h} x {dh} (a rank's heads), fp32 {what}; rel "
                      f"{worst:.3e}, a second call bit-identical; library: SDPA"
                      f"{' fwd+bwd - fwd' if which else ''} on the fp32 head-major views"
                      f"{' after the plain pre_transform' if kind == 'K5' else ''} (TF32 off)",
                      max(e[0] for e in errs), f"rel tol {tol}", time_ms(kernel, reps=5),
                      time_ms(plain, reps=2), flops, nbytes, lib[which](),
                      peak=PEAK_FP32_FLOPS, exps=b * h * n * n)
        del q, k, v, g, fwd, bwd, lib
        torch.cuda.empty_cache()
    for key, rows, d, d_mid in TP_RANK_F32_MLP:
        x = torch.randn(rows, d, generator=gen, device=dev)
        w1 = torch.randn(d_mid, d, generator=gen, device=dev) * d ** -0.5
        b1 = torch.randn(d_mid, generator=gen, device=dev) * 0.1
        w2 = torch.randn(d, d_mid, generator=gen, device=dev) * d_mid ** -0.5
        args = (x, w1.t(), b1, w2.t())
        before = (fm.fp32_launches, fm.fp32_tiled_launches, fm.fp32_dot_launches)
        got, again, want = fm.fused_mlp(*args), fm.fused_mlp(*args), fm.reference_mlp(*args)
        torch.cuda.synchronize()
        launched = tuple(a - c for a, c in zip((fm.fp32_launches, fm.fp32_tiled_launches,
                                                fm.fp32_dot_launches), before))
        route = "tiled" if launched[1] else "dot"
        check(launched[0] == 2 and launched[1] + launched[2] == 2 and 0 in launched[1:],
              f"{key}: launches (fp32, tiled, dot) {launched} for two calls")
        check(torch.equal(got, again), f"{key}: a second call differs")
        abs_err, rel = errors(got, want)
        tol = F32_REL_TOL["K2 fp32"]
        check(rel <= tol, f"{key} rel err {rel} > {tol}")
        plan = fm.tiled_plan(d, d_mid, d, rows) if route == "tiled" else fm.f32_plan(d, d)
        del got, again, want
        table.add(key, f"x [{rows},{d}] -> {d_mid} (a rank's M/tp) -> {d} fp32 partial, the "
                  f"{'outer' if route == 'tiled' else 'dot'}-product route, plan {plan}; rel "
                  f"{rel:.3e}, a second call bit-identical; library: the two-GEMM cuBLAS "
                  f"composition with GELU (not one call)", abs_err, f"rel tol {tol}",
                  time_ms(lambda: fm.fused_mlp(*args), reps=5),
                  time_ms(lambda: fm.reference_mlp(*args), reps=2), 4 * rows * d * d_mid,
                  4 * (2 * rows * d + 2 * d * d_mid + d_mid),
                  time_ms(lambda: linear(gelu(linear(x, w1, b1)), w2), reps=5),
                  peak=PEAK_FP32_FLOPS)
        del x, w1, b1, w2, args
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _grad_errors(got, want):
    """Max abs error, rel error (to max |want|) and gain of each grad."""
    return [(*errors(a, w), gain(a, w)) for a, w in zip(got, want)]


def _bit_identical(first, second) -> bool:
    """Whether two calls' grads agree bit for bit (no atomics, a fixed order)."""
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def k6_counts():
    """K6's counters and K4's, in one tuple: transform launches, K6 calls,
    sm90 backward kernels, of them on cp.async; K4 calls, K4 sm90 kernels."""
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr

    return (fnr.transform_launches, fnr.bwd_launches, fnr.bwd_sm90_launches,
            fnr.bwd_sm90_cp_async_launches, fa.bwd_kv_launches, fa.bwd_sm90_launches)


def backward_checks(dev, gen, table: KernelTable) -> None:
    """K4 and K6 against their plain backwards, and K1's and K5's lse against
    the plain log-sum-exp, at the train shapes (B*L = 32 sequences of 1000
    frames, 16 x 24 and 3 x 128) and at a ragged one; K6 also on the
    cp.async route (v a view one element into its buffer, which TMA cannot
    load). K5 and K6 run the transform kernel and the redesigned pair; their
    rows give the composition of the plain pre_transform and PyTorch's
    attention beside them."""
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr

    bf = torch.bfloat16
    bp = TRAIN_BATCH * L
    shapes = ((bp, HEADS, T, T, HIDDEN // HEADS, "K4"), (3, 3, 130, 257, 64, "K4 ragged"),
              (bp, WIDE_HEADS, T, T, HIDDEN // WIDE_HEADS, "K6"),
              (3, 2, 130, 257, 128, "K6 ragged"), (2, 3, 200, 333, 128, "K6 cp.async"))
    for b, h, nq, nk, dh, key in shapes:
        nr, cp = key.startswith("K6"), key.endswith("cp.async")
        # q/k/v as head-major views of packed linear1-like buffers
        qkv = _rand(gen, b, nq, 3 * h * dh, scale=2.0 if nr else 1.0).to(dev, bf)
        kv = _rand(gen, b, nk, 3 * h * dh + 8 * cp, scale=2.0 if nr else 1.0).to(dev, bf)
        q = qkv[..., :h * dh].unflatten(-1, (h, dh)).transpose(1, 2)
        k = kv[..., h * dh:2 * h * dh].unflatten(-1, (h, dh)).transpose(1, 2)
        v0 = 2 * h * dh + cp
        v = kv[..., v0:v0 + h * dh].unflatten(-1, (h, dh)).transpose(1, 2)
        check(fa.sm90_tma_ok(v) != cp, f"{key}: v's route")
        g = _rand(gen, b, h, nq, dh).to(dev, bf)
        scale = dh ** -0.5
        if nr:
            qs, ks = ((1 + 0.2 * _rand(gen, dh)).to(dev) for _ in range(2))
            cos, sin = rope_cos_sin(max(nq, nk), dh, device=dev)

            def pre(q_, k_):
                return fnr.pre_transform(q_, k_, qs, ks, cos, sin)

            before = k5_counts()
            out, lse = fnr._forward(q, k, v, qs, ks, cos, sin, scale, with_lse=True)
            launched = tuple(a - c for a, c in zip(k5_counts(), before))
            check(launched == (1, 1, 1, int(cp), 0, 0), f"{key}: K5 launches {launched}")
            _, want_lse = fa.reference_attention(*pre(q, k), v, scale, return_lse=True)
            args = (q, k, v, qs, ks, cos, sin, out, lse, g, scale)
            kernel, plain = fnr.flash_attention_normrope_backward, fnr.reference_normrope_backward
            lse_atol, rel_tol = LSE_ATOL["K5"][dh], K6_REL_TOL
            want_launched = (1, 1, 3, int(cp), 0, 0)
        else:
            out, lse = fa._forward(q, k, v, scale, with_lse=True)
            _, want_lse = fa.reference_attention(q, k, v, scale, return_lse=True)
            args = (q, k, v, out, lse, g, scale)
            kernel, plain = fa.flash_attention_backward, fa.reference_flash_backward
            lse_atol, rel_tol = LSE_ATOL["K1"][dh], K4_REL_TOL
            want_launched = (0, 0, 0, 0, 1, 3)
        before = k6_counts()
        got = kernel(*args)
        torch.cuda.synchronize()
        launched = tuple(a - c for a, c in zip(k6_counts(), before))
        check(launched == want_launched, f"{key}: launches {launched} != {want_launched} "
              f"(transform, K6, K6 sm90, K6 cp.async, K4, K4 sm90)")
        want = plain(*args)
        lse_err = (lse - want_lse).abs().max().item()
        errs = _grad_errors(got, want)
        detail = ", ".join(f"{n} rel {r:.3e} gain {gn:.7f}"
                           for n, (_, r, gn) in zip(("dq", "dk", "dv"), errs))
        lse_name = "K5" if nr else "K1"
        print(f"kernel {key} [{b},{h},{nq},{nk},{dh}]: {detail}; {lse_name} lse max_abs_err "
              f"{lse_err:.3e} (atol {lse_atol})")
        check(lse_err <= lse_atol, f"{lse_name} lse err {lse_err} > {lse_atol} at {key}")
        for name, (_, rel, gn) in zip(("dq", "dk", "dv"), errs):
            check(rel <= rel_tol, f"{key} {name} rel err {rel} > {rel_tol}")
            check(abs(gn - 1) <= K1_GAIN_TOL, f"{key} {name} gain {gn} off 1 by > {K1_GAIN_TOL}")
        del got, want
        if key in ("K4", "K6"):
            # five products, 2.5x the forward's FLOPs; q/k/v/out/dO read and
            # dq/dk/dv written once in bf16, lse read once in fp32
            d = h * dh
            shape = f"q/k/v/dO [{b},{h},{nq},{dh}] strided views"
            if nr:
                comp_ms = library_times(q, k, v, scale, grad=g, pre=pre)
                shape += (f", transform kernel + sm90 backward; library none (composition: plain "
                          f"pre_transform + SDPA fwd+bwd - fwd: {comp_ms:.4f} ms)")
                lib = None
            else:
                lib = library_times(q, k, v, scale, grad=g)
            ms, plain_ms = time_ms(lambda: kernel(*args), reps=10), time_ms(lambda: plain(*args),
                                                                            reps=3)
            table.add(key, shape, max(e[0] for e in errs),
                      f"rel tol {rel_tol} per grad, gain tol {K1_GAIN_TOL}", ms, plain_ms,
                      2.5 * 4 * b * nq * nk * d, 8 * b * nq * d * 2 + b * h * nq * 4, lib,
                      exps=b * h * nq * nk)
            # the forward with the lse at the same shape (the train step's K1 / K5)
            fwd = (lambda: fnr._forward(q, k, v, qs, ks, cos, sin, scale, with_lse=True)) if nr \
                else (lambda: fa._forward(q, k, v, scale, with_lse=True))
            lib = library_times(q, k, v, scale, pre=pre) if nr else library_times(q, k, v, scale)
            fwd_key = f"{lse_name} lse"
            extra = f"; library none (composition: plain pre_transform + SDPA: {lib:.4f} ms)" \
                if nr else ""
            table.add(fwd_key, f"q/k/v [{b},{h},{nq},{dh}] strided views, with lse; lse "
                      f"max_abs_err {lse_err:.3e} (atol {lse_atol}){extra}", lse_err,
                      f"atol {lse_atol}", time_ms(fwd),
                      time_ms(lambda: fa.reference_attention(*(pre(q, k) if nr else (q, k)), v,
                                                             scale, return_lse=True)),
                      4 * b * nq * nk * h * dh, 4 * b * nq * h * dh * 2 + b * h * nq * 4,
                      None if nr else lib, exps=b * h * nq * nk)
        del out, lse, args


def _key_mask(gen, b: int, nk: int, dev, lo: int = 1):
    """A ragged [B, Nk] key-padding mask (lengths lo..Nk); row 0 fully masked."""
    lengths = torch.randint(lo, nk + 1, (b,), generator=gen)
    mask = torch.arange(nk)[None, :] < lengths[:, None]
    mask[0] = False
    return mask.to(dev)


def _atom_mask(gen, b: int, dev):
    """An MD17 key-padding mask [B, 32]: molecules of 9..21 atoms."""
    lengths = torch.randint(9, 22, (b,), generator=gen)
    return (torch.arange(MD17_ATOMS)[None, :] < lengths[:, None]).to(dev)


def _check_f32(got, want, name):
    err, rel = errors(got, want)
    check(got.dtype == torch.float32 and got.shape == want.shape, f"{name} shape/dtype")
    check(rel <= K1_F32_REL_TOL, f"{name} rel err {rel} > {K1_F32_REL_TOL}")
    return err, rel


def md17_kernel_checks(dev, gen, table: KernelTable) -> None:
    """K1 with the key-padding bias and with fp32 operands, and K9 forward
    and backward, against their plain versions at the MD17 protocol's shapes
    (stage 1 on B*T = 1920 frames to encode and K*B*T = 9600 to decode; the
    DiT's temporal axis at K*B*L = 61440 sequences of 30 frames) and at
    ragged shapes; the table rows for K1-bias, K1-fp32, K9 and K3-fp32 on
    the fp32 DiT's spatial axis [1920, 192, 256]."""
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import short_attention as tsa

    bf, f32 = torch.bfloat16, torch.float32
    frames = MD17_BATCH * MD17_T
    dh = 16

    # K1-bias: the encoder's cross-attention, 192 latent queries over 32
    # padded atoms, 8 heads, fp32; molecules of 9..21 atoms
    q = _rand(gen, frames, 192, 8 * dh).to(dev).unflatten(-1, (8, dh)).transpose(1, 2)
    kv = _rand(gen, frames, MD17_ATOMS, 16 * dh).to(dev).unflatten(-1, (2, 8, dh))
    k, v = (t.transpose(1, 2) for t in kv.unbind(2))
    mask = _atom_mask(gen, frames, dev)
    args = (q, k, v)
    got, want = fa.flash_attention(*args, mask=mask), fa.reference_attention(*args, mask=mask)
    torch.cuda.synchronize()
    err, rel = _check_f32(got, want, "K1-bias fp32")
    nbytes = (2 * q.numel() + 2 * k.numel()) * 4 + mask.numel() * 4
    table.add("K1 bias", f"fp32 q [{frames},8,192,{dh}] k/v [{frames},8,{MD17_ATOMS},{dh}], "
              f"mask [{frames},{MD17_ATOMS}] (rel {rel:.3e})", err, f"rel tol {K1_F32_REL_TOL}",
              time_ms(lambda: fa.flash_attention(*args, mask=mask)),
              time_ms(lambda: fa.reference_attention(*args, mask=mask)),
              4 * q.numel() * MD17_ATOMS, nbytes,
              library_times(*args, dh ** -0.5, mask=mask), peak=PEAK_FP32_FLOPS,
              exps=q.numel() // dh * MD17_ATOMS)

    # K1-fp32: the latent self-attention, 2 heads over 192 latents, at the
    # decode batch (the encoder's is 5x smaller)
    n_dec = MD17_K * frames
    qkv = _rand(gen, n_dec, 192, 3 * 2 * dh).to(dev).unflatten(-1, (3, 2, dh))
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    got, want = fa.flash_attention(q, k, v), fa.reference_attention(q, k, v)
    torch.cuda.synchronize()
    err, rel = _check_f32(got, want, "K1-fp32")
    table.add("K1 fp32", f"fp32 q/k/v [{n_dec},2,192,{dh}] strided views (rel {rel:.3e})", err,
              f"rel tol {K1_F32_REL_TOL}", time_ms(lambda: fa.flash_attention(q, k, v)),
              time_ms(lambda: fa.reference_attention(q, k, v), reps=5),
              4 * q.numel() * 192, 4 * q.numel() * 4, library_times(q, k, v, dh ** -0.5),
              peak=PEAK_FP32_FLOPS, exps=q.numel() // dh * 192)
    del qkv, q, k, v, got, want

    # K3-fp32: the fp32 DiT's spatial axis in the --test pass (B*T = 1920
    # frames of 192 latents, 16 x dh 16): packed q/k, v a view of linear1's
    # output, on the narrow kernel; drawn on the card by a generator of its
    # own, so the draws below are as before
    d3, g3 = 16 * dh, torch.Generator(device=dev).manual_seed(SEED + 13)
    q, k = (torch.randn(frames, 192, d3, generator=g3, device=dev) for _ in range(2))
    v = torch.randn(frames, 192, 3 * d3, generator=g3, device=dev)[..., 2 * d3:]
    args = (q, k, v, 16)
    before = (fa.fp32_launches, fa.fp32_narrow_launches)
    got, again = fa.flash_attention_packed(*args), fa.flash_attention_packed(*args)
    want = fa.reference_attention_packed(*args)
    torch.cuda.synchronize()
    check((fa.fp32_launches - before[0], fa.fp32_narrow_launches - before[1]) == (2, 2),
          "K3-fp32 at MD17: the narrow fp32 kernel did not launch once a call")
    check(torch.equal(got, again), "K3-fp32 at MD17: a second call on the same inputs differs")
    err, rel = _check_f32(got, want, "K3-fp32 at MD17")
    heads = [t.unflatten(-1, (16, dh)).transpose(1, 2) for t in (q, k, v)]
    table.add("K3 fp32 [1920,192,256]", f"packed fp32 q/k/v [{frames},192,{d3}] (v a strided "
              f"view), 16 x {dh}, the narrow kernel (rel {rel:.3e}), a second call "
              f"bit-identical", err, f"rel tol {K1_F32_REL_TOL}",
              time_ms(lambda: fa.flash_attention_packed(*args), reps=10),
              time_ms(lambda: fa.reference_attention_packed(*args), reps=3),
              4 * q.numel() * 192, 4 * 4 * q.numel(), library_times(*heads, dh ** -0.5),
              peak=PEAK_FP32_FLOPS, exps=frames * 16 * 192 * 192)
    del q, k, v, args, got, again, want, heads

    # K1-bias ragged: keys not a multiple of either kernel's key tile, an
    # all-masked row (uniform weights over its keys), bf16 and fp32
    for dtype in (bf, f32):
        q = _rand(gen, 3, 3, 130, 24).to(dev, dtype)
        k, v = (_rand(gen, 3, 3, 257, 24).to(dev, dtype) for _ in range(2))
        mask = _key_mask(gen, 3, 257, dev)
        got, want = fa.flash_attention(q, k, v, mask=mask), fa.reference_attention(q, k, v,
                                                                                  mask=mask)
        torch.cuda.synchronize()
        uniform = v[0].float().mean(dim=1, keepdim=True).expand_as(got[0])
        if dtype == bf:
            abs_err, _, atol, k1_gain = k1_errors(got, want)
            check_k1(abs_err, atol, k1_gain, "K1-bias bf16 ragged")
            detail = f"max_abs_err {abs_err:.3e} (atol {atol:.3e}), gain {k1_gain:.7f}"
        else:
            abs_err, rel = _check_f32(got, want, "K1-bias fp32 ragged")
            detail = f"max_abs_err {abs_err:.3e} rel {rel:.3e} (rel tol {K1_F32_REL_TOL})"
        row_err = (got[0].float() - uniform).abs().max().item()
        check(row_err <= 2 * bf16_ulp(uniform.abs().max().item()),
              f"all-masked row is not the mean of v: {row_err}")
        print(f"kernel K1-bias {str(dtype)[6:]} ragged [3,3,130,257,24]: {detail}; all-masked "
              f"row vs the mean of v: {row_err:.3e}")

    # K9 on the DiT's temporal axis: q/k contiguous [K*B*L, 30, 256], v a
    # view of linear1's output, 16 heads of 16; these 2.8 G draws (with the
    # backward's g) are made on the card by a generator of their own, as a
    # host generator takes about 14 s for them
    seqs, d = MD17_K * MD17_BATCH * 192, 256
    g9 = torch.Generator(device=dev).manual_seed(SEED + 9)
    q, k = (torch.randn(seqs, MD17_T, d, generator=g9, device=dev).to(bf) for _ in range(2))
    v = torch.randn(seqs, MD17_T, 3 * d, generator=g9, device=dev).to(bf)[..., 2 * d:]
    args = (q, k, v, 16)
    got, want = tsa.short_attention(*args), tsa.reference_short_attention(*args)
    torch.cuda.synchronize()
    check(got.shape == q.shape and got.dtype == bf, "K9 shape/dtype")
    check(torch.equal(got, tsa.short_attention(*args)),
          "K9: a second call on the same inputs differs")
    abs_err, _, atol, k1_gain = k1_errors(got, want)
    check_k1(abs_err, atol, k1_gain, "K9")
    heads = [t.unflatten(-1, (16, dh)).transpose(1, 2) for t in (q, k, v)]
    table.add("K9", f"packed q/k/v [{seqs},{MD17_T},{d}] (v a strided view), 16 x {dh}, a second "
              f"call bit-identical, gain "
              f"{k1_gain:.7f}", abs_err, f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol "
              f"{K1_GAIN_TOL}", time_ms(lambda: tsa.short_attention(*args)),
              time_ms(lambda: tsa.reference_short_attention(*args), reps=5),
              4 * seqs * MD17_T * MD17_T * d, 4 * seqs * MD17_T * d * 2,
              library_times(*heads, dh ** -0.5), exps=seqs * 16 * MD17_T * MD17_T)
    del got, want

    # K9 backward at the same shape, then ragged lengths and head dims
    g = torch.randn(seqs, MD17_T, d, generator=g9, device=dev).to(bf)
    scale = dh ** -0.5
    for b, n, h, hd, key in ((seqs, MD17_T, 16, dh, "K9 backward"), (7, 9, 3, 24, "ragged"),
                             (5, 31, 2, 64, "ragged"), (3, 127, 4, 16, "ragged"),
                             (6, 33, 11, 8, "ragged")):
        if key == "ragged":
            q, k, g = (_rand(gen, b, n, h * hd).to(dev, bf) for _ in range(3))
            v = _rand(gen, b, n, 3 * h * hd).to(dev, bf)[..., -h * hd:]
            got, want = tsa.short_attention(q, k, v, h), tsa.reference_short_attention(q, k, v, h)
            abs_err, _, atol, k1_gain = k1_errors(got, want)
            check_k1(abs_err, atol, k1_gain, f"K9 n={n}")
            check(torch.equal(got, tsa.short_attention(q, k, v, h)),
                  f"K9 n={n}: a second call on the same inputs differs")
            scale = hd ** -0.5
        bargs = (q, k, v, g, h, scale)
        got, want = tsa.short_attention_backward(*bargs), tsa.reference_short_backward(*bargs)
        torch.cuda.synchronize()
        check(_bit_identical(got, tsa.short_attention_backward(*bargs)),
              f"K9 backward n={n}: a second call on the same inputs differs")
        errs = _grad_errors(got, want)
        detail = ", ".join(f"{nm} rel {r:.3e} gain {gn:.7f}"
                           for nm, (_, r, gn) in zip(("dq", "dk", "dv"), errs))
        print(f"kernel {key} [{b},{n},{h}x{hd}]: {detail} (rel tol {K9_GRAD_REL_TOL}, gain tol "
              f"{K1_GAIN_TOL}); a second call bit-identical")
        for nm, (_, rel, gn) in zip(("dq", "dk", "dv"), errs):
            check(rel <= K9_GRAD_REL_TOL, f"K9 backward n={n} {nm} rel err {rel}")
            check(abs(gn - 1) <= K1_GAIN_TOL, f"K9 backward n={n} {nm} gain {gn}")
        if key == "K9 backward":
            # five products (2.5x the forward's FLOPs); q/k/v/dO read and
            # dq/dk/dv written once in bf16; library: SDPA fwd+bwd - fwd
            table.add("K9 bwd", f"packed q/k/v/dO [{seqs},{n},{d}], 16 x {dh}",
                      max(e[0] for e in errs), f"rel tol {K9_GRAD_REL_TOL} per grad, gain tol "
                      f"{K1_GAIN_TOL}", time_ms(lambda: tsa.short_attention_backward(*bargs),
                                                reps=10),
                      time_ms(lambda: tsa.reference_short_backward(*bargs), reps=3),
                      2.5 * 4 * seqs * n * n * d, 7 * seqs * n * d * 2,
                      library_times(*heads, scale, grad=g.unflatten(-1, (16, dh)).transpose(1, 2)),
                      exps=seqs * 16 * n * n)
        del got, want
    torch.cuda.empty_cache()


def md17_dit_kernel_checks(dev, gen, table: KernelTable) -> None:
    """K3, K2 and K7 against their plain versions at the shapes the MD17
    protocol's DiT gives them (K*B = 320 trajectories of T=30 frames of
    L=192 latents, hidden 256, 16 heads of 16): K3 on the spatial axis,
    9,600 sequences x 16 heads = 153,600 (batch, head) pairs, past
    gridDim.y's 65,535, so this is the launch the flash kernels' linear grid
    exists for; K2 and K7 over 1.84 M tokens. Printed rows only: the
    ``kernels`` line keeps the 4AA shapes."""
    from lam_slide_tpu_torch.ops import flash_attention as fa

    bf, d, heads = torch.bfloat16, 256, 16
    trajs = MD17_K * MD17_BATCH
    seqs, tokens = trajs * MD17_T, trajs * MD17_T * 192
    dh = d // heads

    # K3: q/k contiguous (after the QK-norm and RoPE), v a view of linear1's
    # output, as LatentDiT passes them; drawn on the card by a generator of
    # its own (2.4 G draws, about 12 s on a host generator)
    g3 = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, k = (torch.randn(seqs, 192, d, generator=g3, device=dev).to(bf) for _ in range(2))
    v = torch.randn(seqs, 192, 3 * d, generator=g3, device=dev).to(bf)[..., 2 * d:]
    args = (q, k, v, heads)
    got, want = fa.flash_attention_packed(*args), fa.reference_attention_packed(*args)
    torch.cuda.synchronize()
    check(got.shape == q.shape and got.dtype == bf, "K3 MD17 shape/dtype")
    abs_err, _, atol, k1_gain = k1_errors(got, want)
    del got, want
    torch.cuda.empty_cache()
    check_k1(abs_err, atol, k1_gain, "K3 MD17")
    head_major = [t.unflatten(-1, (heads, dh)).transpose(1, 2) for t in (q, k, v)]
    table.add("K3 MD17", f"packed q/k/v [{seqs},192,{d}] (v a strided view), {heads} x {dh}, "
              f"{seqs * heads} (batch, head) pairs, gain {k1_gain:.7f}", abs_err,
              f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
              time_ms(lambda: fa.flash_attention_packed(*args), reps=5),
              time_ms(lambda: fa.reference_attention_packed(*args), reps=2),
              4 * seqs * 192 * 192 * d, 4 * seqs * 192 * d * 2,
              library_times(*head_major, dh ** -0.5), exps=seqs * heads * 192 * 192)
    del q, k, v, args, head_major
    torch.cuda.empty_cache()

    # the stage-2 train step's spatial attention (B*T = 1920 sequences): K3
    # with the lse, then K4 from its out and lse; q/k/v as LatentDiT passes them
    seqs2 = MD17_BATCH * MD17_T
    q, k = (_rand(gen, seqs2, 192, d).to(dev, bf) for _ in range(2))
    v = _rand(gen, seqs2, 192, 3 * d).to(dev, bf)[..., 2 * d:]
    qh, kh, vh = (t.unflatten(-1, (heads, dh)).transpose(1, 2) for t in (q, k, v))
    scale = dh ** -0.5
    out, lse = fa._forward(qh, kh, vh, scale, with_lse=True)
    want, want_lse = fa.reference_attention(qh, kh, vh, scale, return_lse=True)
    torch.cuda.synchronize()
    abs_err, _, atol, k1_gain = k1_errors(out, want)
    lse_err, lse_atol = (lse - want_lse).abs().max().item(), LSE_ATOL["K1"][24]
    del want, want_lse
    check_k1(abs_err, atol, k1_gain, "K3 lse MD17")
    check(lse_err <= lse_atol, f"K3 lse MD17 lse err {lse_err} > {lse_atol}")
    exps2 = seqs2 * heads * 192 * 192
    table.add("K3 lse MD17", f"packed q/k/v [{seqs2},192,{d}] (v a strided view), {heads} x {dh}, "
              f"with lse (max_abs_err {lse_err:.3e}, atol {lse_atol}), gain {k1_gain:.7f}",
              abs_err, f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
              time_ms(lambda: fa._forward(qh, kh, vh, scale, with_lse=True), reps=10),
              time_ms(lambda: fa.reference_attention(qh, kh, vh, scale, return_lse=True), reps=3),
              4 * seqs2 * 192 * 192 * d, 4 * seqs2 * 192 * d * 2 + seqs2 * heads * 192 * 4,
              library_times(qh, kh, vh, scale), exps=exps2)
    torch.cuda.empty_cache()
    g = _rand(gen, seqs2, heads, 192, dh).to(dev, bf)
    args = (qh, kh, vh, out, lse, g, scale)
    got, want = fa.flash_attention_backward(*args), fa.reference_flash_backward(*args)
    torch.cuda.synchronize()
    errs = _grad_errors(got, want)
    del got, want
    torch.cuda.empty_cache()
    detail = ", ".join(f"{n} rel {r:.3e} gain {gn:.7f}"
                       for n, (_, r, gn) in zip(("dq", "dk", "dv"), errs))
    for name, (_, rel, gn) in zip(("dq", "dk", "dv"), errs):
        check(rel <= K4_REL_TOL, f"K4 MD17 {name} rel err {rel} > {K4_REL_TOL}")
        check(abs(gn - 1) <= K1_GAIN_TOL, f"K4 MD17 {name} gain {gn} off 1 by > {K1_GAIN_TOL}")
    table.add("K4 MD17", f"q/k/v/dO [{seqs2},{heads},192,{dh}] strided views; {detail}",
              max(e[0] for e in errs), f"rel tol {K4_REL_TOL} per grad, gain tol {K1_GAIN_TOL}",
              time_ms(lambda: fa.flash_attention_backward(*args), reps=10),
              time_ms(lambda: fa.reference_flash_backward(*args), reps=2),
              2.5 * 4 * seqs2 * 192 * 192 * d, 8 * seqs2 * 192 * d * 2 + seqs2 * heads * 192 * 4,
              library_times(qh, kh, vh, scale, grad=g), exps=exps2)
    del q, k, v, qh, kh, vh, out, lse, g, args
    torch.cuda.empty_cache()

    k2_check(dev, gen, table, "K2 MD17", tokens, d, 2 * d, plain_reps=3)
    k7_check(dev, gen, table, "K7 MD17", trajs, MD17_T, 192, d, plain_reps=3)
    torch.cuda.empty_cache()


def f32_kernel_cases(dev, seed: int) -> dict:
    """The fp32 kernels of the MD17 test pass at its shapes (B=64, T=30,
    L=192, hidden 256, 16 x dh 16) on one seed's inputs, as the fp32 DiT
    hands them over: name -> dict of the kernel call, the plain call, a
    call that times the library's version in ms (or None), the shape text
    and the FLOPs, bytes and exponentials of the bound. K2: x and the MLP
    slices of linear1's and linear2's nn.Linear weights as transposed views;
    its library version is the two-GEMM cuBLAS composition with PyTorch's
    GELU (not one call). K7: the
    residual stream, h the transposed temporal output, gate/shift/scale
    chunks of one [B, 1, 1, 6D] tensor; both calls return (x_new, y); no
    library call computes it, so ``composition`` (F.layer_norm + the
    modulate) is timed beside it, and ``variant`` is the pair of calls
    without the residual. K9: packed q/k/v views of one linear1 output over
    the temporal axis; its library call is SDPA on their head-major views."""
    from torch.nn.functional import gelu, layer_norm, linear

    from lam_slide_tpu_torch.ops import fused_adaln as fad
    from lam_slide_tpu_torch.ops import fused_mlp as fm
    from lam_slide_tpu_torch.ops import short_attention as tsa

    gen = torch.Generator().manual_seed(seed)
    b, t, l, d, heads = MD17_BATCH, MD17_T, MD17_LATENTS, MD17_HIDDEN, MD17_HEADS
    m, rows, dh = 2 * d, b * t * l, d // heads
    x = _rand(gen, rows, d).to(dev)
    lin1 = _rand(gen, 3 * d + m, d, scale=d ** -0.5).to(dev)
    b1 = _rand(gen, m, scale=0.1).to(dev)
    lin2 = _rand(gen, d, d + m, scale=(d + m) ** -0.5).to(dev)
    mlp = (x, lin1[3 * d:].t(), b1, lin2[:, d:].t())
    x7 = _rand(gen, b, t, l, d, scale=3.0).to(dev)
    h7 = _rand(gen, b, l, t, d).to(dev).transpose(1, 2)
    shift, scale, gate = _rand(gen, b, 1, 1, 6 * d, scale=0.5).to(dev).chunk(6, -1)[:3]
    ada = (x7, h7, gate, shift, scale)
    q, k, v = _rand(gen, b * l, t, 3 * d).to(dev).chunk(3, -1)
    heads_major = [z.unflatten(-1, (heads, dh)).transpose(1, 2) for z in (q, k, v)]
    return {
        "K2 fp32": dict(
            kernel=lambda: fm.fused_mlp(*mlp), plain=lambda: fm.reference_mlp(*mlp),
            library_ms=lambda: time_ms(
                lambda: linear(gelu(linear(x, lin1[3 * d:], b1)), lin2[:, d:]), reps=5),
            shape=f"x [{rows},{d}] w1 [{d},{m}] w2 [{m},{d}] transposed nn.Linear views, "
                  f"outer-product kernel, plan {fm.tiled_plan(d, m, d, rows)}; library: the "
                  f"two-GEMM cuBLAS composition with GELU (not one call)",
            flops=4 * rows * d * m, nbytes=4 * (2 * rows * d + 2 * d * m + m), exps=0),
        "K7 fp32": dict(
            kernel=lambda: fad.residual_adaln_modulate(*ada),
            plain=lambda: fad.reference_residual_adaln_modulate(*ada), library_ms=None,
            composition=lambda: fad.modulate(layer_norm(x7 + gate * h7, (d,), eps=1e-6),
                                             shift, scale),
            variant=(lambda: fad.adaln_modulate(x7, shift, scale),
                     lambda: fad.reference_adaln_modulate(x7, shift, scale)),
            shape=f"x/h [{b},{t},{l},{d}] (h the transposed temporal view)",
            flops=0, nbytes=4 * (4 * rows * d + 3 * b * d), exps=0),
        "K9 fp32": dict(
            kernel=lambda: tsa.short_attention(q, k, v, heads),
            plain=lambda: tsa.reference_short_attention(q, k, v, heads, dh ** -0.5),
            library_ms=lambda: library_times(*heads_major, dh ** -0.5),
            shape=f"packed q/k/v [{b * l},{t},{d}] views of one [{b * l},{t},{3 * d}] buffer, "
                  f"{heads} x {dh}; library: SDPA on fp32 head-major views",
            flops=4 * b * l * heads * t * t * dh, nbytes=4 * 4 * b * l * t * d,
            exps=b * l * heads * t * t),
    }


def f32_kernel_outputs(dev, seed: int) -> dict:
    """name -> (kernel output, plain output, x_new bit-identical (K7) or None)
    for ``f32_kernel_cases`` on one seed's inputs."""
    out = {}
    for name, case in f32_kernel_cases(dev, seed).items():
        got, want = case["kernel"](), case["plain"]()
        exact = None
        if name == "K7 fp32":
            exact = torch.equal(got[0], want[0])
            got, want = got[1], want[1]
        out[name] = (got, want, exact)
    torch.cuda.synchronize()
    return out


def md17_f32_kernel_checks(dev, table: KernelTable) -> None:
    """K2-fp32, K7-fp32 and K9-fp32's forward against their plain versions
    (TF32 off) at the MD17 test pass's shapes, within F32_REL_TOL, on the
    first seed of tools/f32_readings.py; K7's x_new bit-identical and its
    modulation without the residual within the same limit; each kernel's
    fp32 counter moves once a call; a second call bit-identical; times beside
    the plain version's and the library's, and the fp32 bound."""
    from lam_slide_tpu_torch.ops import fused_adaln as fad
    from lam_slide_tpu_torch.ops import fused_mlp as fm
    from lam_slide_tpu_torch.ops import short_attention as tsa

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    counters = {"K2 fp32": fm, "K7 fp32": fad, "K9 fp32": tsa}
    for name, case in f32_kernel_cases(dev, 20).items():
        mod, tol = counters[name], F32_REL_TOL[name]
        before = (mod.launches, mod.fp32_launches, fm.fp32_tiled_launches)
        got, again, want = case["kernel"](), case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        check((mod.launches - before[0], mod.fp32_launches - before[1]) == (2, 2),
              f"{name}: the fp32 kernel did not launch once a call")
        check(fm.fp32_tiled_launches - before[2] == (2 if name == "K2 fp32" else 0),
              f"{name}: K2-fp32 did not take its outer-product kernel")
        extra = ""
        if name == "K7 fp32":
            check(torch.equal(got[0], want[0]), "K7 fp32 x_new is not bit-identical")
            check(torch.equal(got[0], again[0]), "K7 fp32: a second call's x_new differs")
            got, again, want = got[1], again[1], want[1]
            kernel0, plain0 = case["variant"]
            rel0 = errors(kernel0(), plain0())[1]
            check(rel0 <= tol, f"{name} (no residual) rel err {rel0} > {tol}")
            extra = (f"; x_new bit-identical; y without residual rel {rel0:.3e}; library: none "
                     f"(F.layer_norm + modulate {time_ms(case['composition'], reps=5):.4f} ms)")
        check(torch.equal(got, again), f"{name}: a second call on the same inputs differs")
        check(got.dtype == torch.float32 and got.shape == want.shape, f"{name} shape/dtype")
        abs_err, rel = errors(got, want)
        del got, again, want
        torch.cuda.empty_cache()
        check(rel <= tol, f"{name} rel err {rel} > {tol}")
        library_ms = case["library_ms"]
        table.add(name, f"{case['shape']}; rel {rel:.3e}, a second call bit-identical{extra}",
                  abs_err, f"rel tol {tol}", time_ms(case["kernel"], reps=5),
                  time_ms(case["plain"], reps=3), case["flops"], case["nbytes"],
                  None if library_ms is None else library_ms(),
                  peak=PEAK_FP32_FLOPS, exps=case["exps"])
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# K2-fp32 beyond the MD17 and 4AA sampling rows: (rows, d, route) at the 4AA
# eval's B = 2 (the 384 instance at 32 rows a block: 125 blocks), the smoke
# width (the 32 instance, hidden 32 at mlp_ratio 2) and hidden 96, which
# has no outer-product instance and takes the dot-product kernel.
K2_F32_ROUTE_SPECS = ((4000, 384, "tiled"), (4096, 32, "tiled"), (16000, 96, "dot"))


def k2_f32_route_checks(dev, table: KernelTable) -> None:
    """K2-fp32 at K2_F32_ROUTE_SPECS against its plain version (TF32 off)
    within F32_REL_TOL, each on the route its plan gives (the counters move
    once a call), a second call bit-identical; then the two routes on the
    same MD17-width inputs (36,864 rows of 256 -> 512 -> 256), which sum in
    one order and must agree bit for bit."""
    from torch.nn.functional import gelu, linear

    from lam_slide_tpu_torch.ops import _build
    from lam_slide_tpu_torch.ops import fused_mlp as fm

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 11)
    tol = F32_REL_TOL["K2 fp32"]

    def operands(rows, d):
        x = _rand(gen, rows, d).to(dev)
        lin1 = _rand(gen, 3 * d + 2 * d, d, scale=d ** -0.5).to(dev)
        b1 = _rand(gen, 2 * d, scale=0.1).to(dev)
        lin2 = _rand(gen, d, 3 * d, scale=(3 * d) ** -0.5).to(dev)
        return (x, lin1[3 * d:].t(), b1, lin2[:, d:].t()), lin1[3 * d:], lin2[:, d:]

    for rows, d, route in K2_F32_ROUTE_SPECS:
        args, l1, l2 = operands(rows, d)
        before = (fm.fp32_tiled_launches, fm.fp32_dot_launches)
        got, again, want = fm.fused_mlp(*args), fm.fused_mlp(*args), fm.reference_mlp(*args)
        torch.cuda.synchronize()
        moved = (fm.fp32_tiled_launches - before[0], fm.fp32_dot_launches - before[1])
        check(moved == ((2, 0) if route == "tiled" else (0, 2)),
              f"K2 fp32 [{rows},{d}]: routes (tiled, dot) launched {moved}, not the {route} one")
        check(torch.equal(got, again), f"K2 fp32 [{rows},{d}]: a second call differs")
        abs_err, rel = errors(got, want)
        check(rel <= tol, f"K2 fp32 [{rows},{d}] rel err {rel} > {tol}")
        plan = fm.tiled_plan(d, 2 * d, d, rows) if route == "tiled" else fm.f32_plan(d, d)
        x = args[0]
        table.add(f"K2 fp32 {route} [{rows},{d}]", f"x [{rows},{d}] -> {2 * d} -> {d}, the "
                  f"{'outer' if route == 'tiled' else 'dot'}-product kernel, plan {plan}; rel "
                  f"{rel:.3e}, a second call bit-identical", abs_err, f"rel tol {tol}",
                  time_ms(lambda: fm.fused_mlp(*args), reps=10),
                  time_ms(lambda: fm.reference_mlp(*args), reps=3), 8 * rows * d * d,
                  4 * (2 * rows * d + 4 * d * d + 2 * d),
                  time_ms(lambda: linear(gelu(linear(x, l1, args[2])), l2), reps=10),
                  peak=PEAK_FP32_FLOPS)
        del args, got, again, want, x
    args, _, _ = operands(36864, MD17_HIDDEN)
    x, w1, b1, w2 = args
    d = MD17_HIDDEN
    dot = torch.empty(36864, d, device=dev)
    with torch.cuda.device(dev):
        _build.launch("lam_fused_mlp_f32", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), dot.data_ptr(), 36864, d, 2 * d, d, x.stride(0),
                      w1.stride(1), w2.stride(1), dot.stride(0), *fm.f32_plan(d, d),
                      torch.cuda.current_stream(dev).cuda_stream)
    got = fm.fused_mlp(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, dot), "K2 fp32: the outer- and dot-product kernels differ at MD17's "
          "widths")
    print("kernel K2 fp32 routes: the outer- and dot-product kernels bit-identical at "
          f"[36864,{d}] -> {2 * d} -> {d}")
    del args, x, w1, b1, w2, dot, got
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def peptide_f32_kernel_checks(dev, gen, table: KernelTable) -> None:
    """The fp32 kernels of the 4AA eval's DiT against their plain versions
    (TF32 off) at its shapes: K8-fp32 at [8000, 2, 384] (the ``kernels``
    line's row, with the two bare cuBLAS SGEMMs of its shapes as its library
    time) and at the eval's [2000, 2, 384], at both head splits, on its
    outer-product kernel and bit-identical to the dot-product route; K3-fp32
    (packed q/k/v views, as LatentDiT passes them) at [4, 1000, 384] and
    [16, 1000, 384], 16 x 24, on the narrow kernel; K2-fp32 at 16,000 tokens
    of 384 -> 768 -> 384; K7-fp32 at [8, 1000, 2, 384]. Each launches its
    fp32 kernel once a call and repeats bit for bit."""
    from torch.nn.functional import gelu, linear

    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    d, m = HIDDEN, MLP_RATIO * HIDDEN
    tol = PEP_F32_REL_TOL["K8 fp32"]
    for n, heads in ((8000, HEADS), (2000, HEADS), (8000, WIDE_HEADS), (2000, WIDE_HEADS)):
        x = _rand(gen, n, L, d).to(dev)
        w1 = _rand(gen, 3 * d + m, d, scale=d ** -0.5).to(dev)
        b1 = _rand(gen, 3 * d + m, scale=0.1).to(dev)
        w2 = _rand(gen, d, d + m, scale=(d + m) ** -0.5).to(dev)
        b2 = _rand(gen, d, scale=0.1).to(dev)
        args8 = k8_args(dev, gen, x, w1, b1, w2, b2, heads)
        names = ("launches", "f32_launches", "wmma_launches", "f32_tiled_launches",
                 "f32_dot_launches")
        before = [getattr(fsb, name) for name in names]
        got, again = fsb.fused_spatial_block(*args8), fsb.fused_spatial_block(*args8)
        want = fsb.reference_spatial_block(*args8)
        torch.cuda.synchronize()
        launched = tuple(getattr(fsb, name) - b for name, b in zip(names, before))
        check(launched == (2, 2, 0, 2, 0), f"K8 fp32: launches {launched} of (K8, fp32, WMMA, "
              f"outer-product, dot-product) for two calls")
        check(got.dtype == torch.float32 and got.shape == x.shape, "K8 fp32 shape/dtype")
        check(torch.equal(got, again), "K8 fp32: a second call on the same inputs differs")
        abs_err, rel = errors(got, want)
        check(rel <= tol, f"K8 fp32 [{n},{L},{d}] {heads} heads rel err {rel} > {tol}")
        # the dot-product route on the same inputs sums in the same order
        plan = fsb.f32_plan(n, L, d, m, heads)
        dot = fsb._launch_f32_dot(*args8)
        torch.cuda.synchronize()
        check(torch.equal(got, dot), f"K8 fp32 [{n},{L},{d}] {heads} heads: the outer- and "
              f"dot-product kernels differ")
        rows = n * L
        mid = torch.empty(rows, d + m, device=dev)

        def sgemms():
            linear(x.view(rows, d), w1, b1)
            return linear(mid, w2, b2)

        key = ("K8 fp32" if (n, heads) == (8000, HEADS)
               else f"K8 fp32 [{n},{L},{d}] {heads}x{d // heads}")
        table.add(key, f"x [{n},{L},{d}] heads {heads} x {d // heads}, fp32, the "
                  f"outer-product kernel (plan: group {plan.group}, 32 rows a block, "
                  f"{plan.blocks} blocks, {plan.smem} B), rel {rel:.3e}, a "
                  f"second call and the dot-product route bit-identical; library: two bare "
                  f"cuBLAS SGEMMs of its shapes",
                  abs_err, f"rel tol {tol}", time_ms(lambda: fsb.fused_spatial_block(*args8)),
                  time_ms(lambda: fsb.reference_spatial_block(*args8), reps=5),
                  2 * rows * (d * (3 * d + m) + (d + m) * d),
                  4 * (2 * rows * d + (3 * d + m) * (d + 1) + d * (d + m + 1)),
                  time_ms(sgemms), peak=PEAK_FP32_FLOPS)
        del x, w1, b1, w2, b2, args8, got, again, want, mid, dot
    # ragged last blocks of the outer-product kernel: frames that do not
    # fill a 32-row block, L = 1, 3 (30 rows used) and 8, both splits; a
    # generator of their own, so the draws below are as before
    gr = torch.Generator().manual_seed(SEED + 14)
    for n, l, heads in ((3999, 1, HEADS), (1001, 3, WIDE_HEADS), (37, 8, HEADS)):
        x = _rand(gr, n, l, d).to(dev)
        w1 = _rand(gr, 3 * d + m, d, scale=d ** -0.5).to(dev)
        b1 = _rand(gr, 3 * d + m, scale=0.1).to(dev)
        w2 = _rand(gr, d, d + m, scale=(d + m) ** -0.5).to(dev)
        b2 = _rand(gr, d, scale=0.1).to(dev)
        args8 = k8_args(dev, gr, x, w1, b1, w2, b2, heads)
        before = fsb.f32_tiled_launches
        got, again = fsb.fused_spatial_block(*args8), fsb.fused_spatial_block(*args8)
        want = fsb.reference_spatial_block(*args8)
        torch.cuda.synchronize()
        check(fsb.f32_tiled_launches - before == 2,
              f"K8 fp32 [{n},{l},{d}]: the outer-product kernel did not launch once a call")
        check(torch.equal(got, again), f"K8 fp32 [{n},{l},{d}]: a second call differs")
        _, rel = errors(got, want)
        check(rel <= tol, f"K8 fp32 [{n},{l},{d}] {heads} heads rel err {rel} > {tol}")
        print(f"kernel K8 fp32 ragged [{n},{l},{d}] {heads}x{d // heads}: rel {rel:.3e} (rel tol "
              f"{tol}), a second call bit-identical")
        del x, w1, b1, w2, b2, args8, got, again, want
    torch.cuda.empty_cache()

    dh = d // HEADS
    for b in (2, 8):
        # q/k contiguous (after the QK-norm and RoPE), v a view of linear1's
        # output, as LatentDiT passes them over the temporal axis
        seqs = b * L
        q, k = (_rand(gen, seqs, T, d).to(dev) for _ in range(2))
        v = _rand(gen, seqs, T, 3 * d).to(dev)[..., 2 * d:]
        args = (q, k, v, HEADS)
        before = (fa.launches, fa.fp32_launches, fa.fp32_narrow_launches)
        got, again = fa.flash_attention_packed(*args), fa.flash_attention_packed(*args)
        want = fa.reference_attention_packed(*args)
        torch.cuda.synchronize()
        check((fa.launches - before[0], fa.fp32_launches - before[1],
               fa.fp32_narrow_launches - before[2]) == (2, 2, 2),
              "K3 fp32: the narrow fp32 kernel did not launch once a call")
        check(torch.equal(got, again), "K3 fp32: a second call on the same inputs differs")
        abs_err, rel = errors(got, want)
        tol3 = PEP_F32_REL_TOL["K3 fp32"]
        check(rel <= tol3, f"K3 fp32 [{seqs},{T},{d}] rel err {rel} > {tol3}")
        head_major = [t.unflatten(-1, (HEADS, dh)).transpose(1, 2) for t in (q, k, v)]
        table.add(f"K3 fp32 [{seqs},{T},{d}]", f"packed fp32 q/k/v [{seqs},{T},{d}] (v a strided "
                  f"view), {HEADS} x {dh}, rel {rel:.3e}, a second call bit-identical",
                  abs_err, f"rel tol {tol3}",
                  time_ms(lambda: fa.flash_attention_packed(*args), reps=10),
                  time_ms(lambda: fa.reference_attention_packed(*args), reps=3),
                  4 * seqs * T * T * d, 4 * 4 * seqs * T * d,
                  library_times(*head_major, dh ** -0.5), peak=PEAK_FP32_FLOPS,
                  exps=seqs * HEADS * T * T)
        del q, k, v, args, got, again, want, head_major
    torch.cuda.empty_cache()

    from lam_slide_tpu_torch.ops import fused_adaln as fad
    from lam_slide_tpu_torch.ops import fused_mlp as fm

    rows = 8 * T * L
    x2 = _rand(gen, rows, d).to(dev)
    lin1 = _rand(gen, 3 * d + m, d, scale=d ** -0.5).to(dev)
    mb1 = _rand(gen, m, scale=0.1).to(dev)
    lin2 = _rand(gen, d, d + m, scale=(d + m) ** -0.5).to(dev)
    mlp = (x2, lin1[3 * d:].t(), mb1, lin2[:, d:].t())
    x7 = _rand(gen, 8, T, L, d, scale=3.0).to(dev)
    h7 = _rand(gen, 8, L, T, d).to(dev).transpose(1, 2)
    shift, scale, gate = _rand(gen, 8, 1, 1, 6 * d, scale=0.5).to(dev).chunk(6, -1)[:3]
    ada = (x7, h7, gate, shift, scale)
    cases = (("K2 fp32", fm, lambda: fm.fused_mlp(*mlp), lambda: fm.reference_mlp(*mlp),
              f"x [{rows},{d}] w1 [{d},{m}] w2 [{m},{d}] transposed nn.Linear views, "
              f"outer-product kernel, plan {fm.tiled_plan(d, m, d, rows)}", 4 * rows * d * m,
              4 * (2 * rows * d + 2 * d * m + m),
              lambda: time_ms(lambda: linear(gelu(linear(x2, lin1[3 * d:], mb1)), lin2[:, d:]),
                              reps=10)),
             ("K7 fp32", fad, lambda: fad.residual_adaln_modulate(*ada),
              lambda: fad.reference_residual_adaln_modulate(*ada),
              f"x/h [8,{T},{L},{d}] (h the transposed temporal view)", 0,
              4 * (4 * rows * d + 3 * 8 * d), None))
    for name, mod, kern, plain, shape, flops, nbytes, lib in cases:
        before = (mod.launches, mod.fp32_launches, fm.fp32_tiled_launches)
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check((mod.launches - before[0], mod.fp32_launches - before[1]) == (2, 2),
              f"{name} 4AA: the fp32 kernel did not launch once a call")
        check(fm.fp32_tiled_launches - before[2] == (2 if name == "K2 fp32" else 0),
              f"{name} 4AA: K2-fp32 did not take its outer-product kernel")
        if name == "K7 fp32":
            check(torch.equal(got[0], want[0]), "K7 fp32 4AA: x_new is not bit-identical")
            got, again, want = got[1], again[1], want[1]
        check(torch.equal(got, again), f"{name} 4AA: a second call on the same inputs differs")
        abs_err, rel = errors(got, want)
        tol = PEP_F32_REL_TOL[name]
        check(rel <= tol, f"{name} 4AA rel err {rel} > {tol}")
        table.add(f"{name} 4AA", f"{shape}; rel {rel:.3e}, a second call bit-identical",
                  abs_err, f"rel tol {tol}", time_ms(kern, reps=10), time_ms(plain, reps=3),
                  flops, nbytes, None if lib is None else lib(), peak=PEAK_FP32_FLOPS)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    torch.cuda.empty_cache()


# dh 128 in fp32 (phase 3): (key, kind, b, heads, nq, nk, dh, lse, masked,
# timed). "K1": K1's fp32 kernel over 64 < dh <= 128 on head-major views;
# "transform": the fp32 QK-norm + RoPE transform; "K5": K5 in fp32 (the
# transform, then K1's fp32 kernel). The 4AA eval's temporal axis at 3 x 128
# (B*L = 4 sequences a window of two peptides; the issue's [2, ...] and the
# sampling B's [8, ...]), the MD17 fp32 DiT's at 2 x 128 (B = 64: spatial
# [1920, 2, 192], temporal [12288, 2, 30]), ragged and edge shapes. Timed
# rows go to the table; the others are printed.
DH128_SPECS = (
    ("K1 fp32 dh128", "K1", 1920, 2, 192, 192, 128, False, False, True),
    ("K1 fp32 dh128 [12288,2,30,128]", "K1", 12288, 2, 30, 30, 128, False, False, True),
    ("K1 fp32 dh128 [8,3,1000,128]", "K1", 8, 3, 1000, 1000, 128, False, False, True),
    ("K1 fp32 dh128 [4,3,1000,128]", "K1", 4, 3, 1000, 1000, 128, False, False, True),
    ("K1 fp32 dh128 [16,3,1000,128]", "K1", 16, 3, 1000, 1000, 128, False, False, True),
    ("K1 fp32 dh128 lse [2,3,1000,128]", "K1", 2, 3, 1000, 1000, 128, True, False, True),
    ("K1 fp32 dh96 lse [64,4,192,96]", "K1", 64, 4, 192, 192, 96, True, False, False),
    ("K1 fp32 dh72 ragged [3,2,77->45,72]", "K1", 3, 2, 77, 45, 72, False, False, False),
    ("K1 fp32 dh128 bias ragged [3,2,130->257,128]", "K1", 3, 2, 130, 257, 128, True, True,
     False),
    ("K1 fp32 dh128 [22000,3,20,128] (66,000 batch x heads)", "K1", 22000, 3, 20, 20, 128,
     False, False, False),
    ("K5 transform fp32", "transform", 8, 3, 1000, 1000, 128, False, False, True),
    ("K5 transform fp32 [1920,2,192,128]", "transform", 1920, 2, 192, 192, 128, False, False,
     True),
    ("K5 transform fp32 [12288,2,30,128]", "transform", 12288, 2, 30, 30, 128, False, False,
     True),
    ("K5 fp32 [2,3,1000,128]", "K5", 2, 3, 1000, 1000, 128, False, False, True),
    ("K5 fp32", "K5", 8, 3, 1000, 1000, 128, False, False, True),
    ("K5 fp32 [4,3,1000,128]", "K5", 4, 3, 1000, 1000, 128, False, False, True),
    ("K5 fp32 [16,3,1000,128]", "K5", 16, 3, 1000, 1000, 128, False, False, True),
    ("K5 fp32 [1920,2,192,128]", "K5", 1920, 2, 192, 192, 128, False, False, True),
    ("K5 fp32 [12288,2,30,128]", "K5", 12288, 2, 30, 30, 128, False, False, True),
    ("K5 fp32 ragged [3,2,130->257,96]", "K5", 3, 2, 130, 257, 96, False, False, False),
)


def dh128_inputs(dev, spec, seed: int):
    """fp32 inputs of one DH128_SPECS row from a card generator seeded with
    ``seed``: q/k/v head-major strided views of packed linear1-like buffers
    (as the DiT passes them), the QK-norm scales around 1 and the RoPE
    tables for the K5 and transform rows, a ragged key-padding mask (row 0
    all masked) for the masked rows."""
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin

    _, kind, b, h, nq, nk, dh, _, masked, _ = spec
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 2.0 if kind != "K1" else 1.0
    qbuf = scale * torch.randn(b, nq, 3 * h * dh, generator=gen, device=dev)
    kvbuf = scale * torch.randn(b, nk, 3 * h * dh, generator=gen, device=dev)
    q = qbuf[..., :h * dh].unflatten(-1, (h, dh)).transpose(1, 2)
    k = kvbuf[..., h * dh:2 * h * dh].unflatten(-1, (h, dh)).transpose(1, 2)
    v = kvbuf[..., 2 * h * dh:].unflatten(-1, (h, dh)).transpose(1, 2)
    out = dict(q=q, k=k, v=v)
    if kind != "K1":
        out["qs"], out["ks"] = (1 + 0.2 * torch.randn(dh, generator=gen, device=dev)
                                for _ in range(2))
        out["cos"], out["sin"] = rope_cos_sin(max(nq, nk), dh, device=dev)
    if masked:
        lengths = torch.randint(1, nk + 1, (b,), generator=gen, device=dev)
        mask = torch.arange(nk, device=dev)[None, :] < lengths[:, None]
        mask[0] = False
        out["mask"] = mask
    return out


def dh128_errors(dev, spec, seed: int):
    """One DH128_SPECS row at ``seed``, kernel against plain (TF32 off):
    (rel err to max |out| (the transform: the larger of q_t's and k_t's),
    lse abs err or None, the inputs, the kernel's and plain calls, extra
    text). Checks the launches of the first call and that a second call
    repeats it bit for bit."""
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr

    key, kind, b, h, nq, nk, dh, with_lse, masked, _ = spec
    x = dh128_inputs(dev, spec, seed)
    q, k, v, mask = x["q"], x["k"], x["v"], x.get("mask")
    scale = dh ** -0.5

    def counts():
        return (fa.launches, fa.fp32_launches, fa.bias_launches, fa.sm90_launches,
                fa.fp32_wide_launches, fnr.launches, fnr.fp32_launches, fnr.transform_launches,
                fnr.sm90_launches, fnr.fp32_wide_launches)

    before = counts()
    lse_err, extra = None, ""
    if kind == "K1":
        def kernel():
            return fa._forward(q, k, v, scale, with_lse, mask)

        def plain():
            return fa.reference_attention(q, k, v, scale, return_lse=with_lse, mask=mask)

        want_launched = (1, 1, int(masked), 0, int(dh > 64), 0, 0, 0, 0, 0)
    elif kind == "transform":
        tr = (q, k, x["qs"], x["ks"], x["cos"], x["sin"])

        def kernel():
            return fnr.qk_normrope(*tr)

        def plain():
            return fnr.pre_transform(*tr)

        want_launched = (0, 0, 0, 0, 0, 0, 0, 1, 0, 0)
    else:
        args5 = (q, k, v, x["qs"], x["ks"], x["cos"], x["sin"])

        def kernel():
            return fnr.flash_attention_normrope(*args5)

        def plain():
            return fnr.reference_attention_normrope(*args5)

        want_launched = (0, 0, 0, 0, 0, 1, 1, 1, 0, int(dh > 64))
    got = kernel()
    torch.cuda.synchronize()
    launched = tuple(a - c for a, c in zip(counts(), before))
    check(launched == want_launched, f"{key}: launches {launched} != {want_launched} (K1, K1 "
          f"fp32, K1 bias, K1 sm90, K1 fp32 wide, K5, K5 fp32, transform, K5 sm90, K5 fp32 "
          f"wide)")
    again = kernel()
    want = plain()
    torch.cuda.synchronize()
    if kind == "transform":
        check(all(t.is_contiguous() and t.dtype == torch.float32 and t.shape == w.shape
                  for t, w in zip(got, want)), f"{key}: q_t/k_t not contiguous fp32")
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"{key}: a second call on the same inputs differs")
        errs = [errors(t, w) for t, w in zip(got, want)]
        return max(e[1] for e in errs), None, max(e[0] for e in errs), x, kernel, plain, extra
    if kind == "K1":
        (got, lse), (again, _) = got, again
        if with_lse:
            want, want_lse = want
            lse_err = (lse - want_lse).abs().max().item()
        if masked:
            uniform = v[0].mean(dim=1, keepdim=True).expand_as(got[0])
            row_err = (got[0] - uniform).abs().max().item()
            check(row_err <= 1e-5, f"{key}: all-masked row is not the mean of v: {row_err}")
            extra = f"; all-masked row vs the mean of v {row_err:.3e}"
    check(got.dtype == torch.float32 and got.shape == want.shape, f"{key} shape/dtype")
    check(torch.equal(got, again), f"{key}: a second call on the same inputs differs")
    abs_err, rel = errors(got, want)
    return rel, lse_err, abs_err, x, kernel, plain, extra


def dh128_kernel_checks(dev, table: KernelTable) -> None:
    """The fp32 kernels at dh 128 (K1-fp32 over 64 < dh <= 128, the fp32
    transform, K5-fp32) against their plain versions with TF32 off at the
    shapes of DH128_SPECS, on the first seed of tools/dh128_readings.py:
    launches, a second call bit-identical, the limits; the timed rows with
    the plain version's time, the library's (SDPA on fp32 head-major tensors,
    and for K5 the composition of the plain pre_transform and SDPA) and the
    fp32 bound."""
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for spec in DH128_SPECS:
        key, kind, b, h, nq, nk, dh, with_lse, masked, timed = spec
        rel, lse_err, abs_err, x, kernel, plain, extra = dh128_errors(dev, spec, 0)
        tol = {"K1": K1_F32_WIDE_REL_TOL, "transform": TRANSFORM_F32_REL_TOL,
               "K5": K5_F32_REL_TOL}[kind]
        lse_text = "" if lse_err is None else f", lse max_abs_err {lse_err:.3e} (atol " \
                                               f"{LSE_F32_WIDE_ATOL})"
        check(rel <= tol, f"{key} rel err {rel} > {tol}")
        check(lse_err is None or lse_err <= LSE_F32_WIDE_ATOL,
              f"{key} lse err {lse_err} > {LSE_F32_WIDE_ATOL}")
        shape = f"[{b},{h},{nq}->{nk},{dh}]" if nq != nk else f"[{b},{h},{nq},{dh}]"
        if not timed:
            print(f"kernel {key} fp32 {shape}: max_abs_err {abs_err:.3e} rel {rel:.3e} (rel tol "
                  f"{tol}){lse_text}{extra}; a second call bit-identical")
            del x
            torch.cuda.empty_cache()
            continue
        q, k, v = x["q"], x["k"], x["v"]
        elems = q.numel() + k.numel()
        scores = b * h * nq * nk
        flops = 4 * scores * dh
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel()) + (4 * b * h * nq if with_lse else 0)
        library = None
        if kind == "transform":
            text = (f"raw fp32 q/k {shape} strided views -> contiguous q_t/k_t, rel {rel:.3e}, a "
                    f"second call bit-identical; time: the kernel's device time (profiler), "
                    f"the wrapper's event time {time_ms(kernel, reps=10):.4f} ms")
            ms = device_ms(kernel, "qk_normrope_kernel", reps=10)
            flops, nbytes = 8 * elems, 2 * elems * 4 + 2 * x["cos"].numel() * 4 + 2 * dh * 4
            exps = 0
        else:
            exps = scores
            ms = time_ms(kernel, reps=10)
            if kind == "K1":
                text = (f"fp32 q/k/v {shape} strided views, register-tiled (plan "
                        f"{fa.f32_wide_plan(nq, nk)}), rel {rel:.3e}"
                        f"{lse_text}, a second call bit-identical; library: SDPA on the fp32 "
                        f"head-major views (TF32 off)")
                library = library_times(q, k, v, dh ** -0.5)
            else:
                tr = (x["qs"], x["ks"], x["cos"], x["sin"])
                comp_ms = library_times(q, k, v, dh ** -0.5,
                                        pre=lambda q_, k_: fnr.pre_transform(q_, k_, *tr))
                dev_ms = device_ms(kernel, ("qk_normrope_kernel", "flash_fwd_f32_tiled_kernel"),
                                   reps=5)
                text = (f"raw fp32 q/k/v {shape} strided views, fp32 transform + K1-fp32 "
                        f"(register-tiled, plan {fa.f32_wide_plan(nq, nk)}), rel "
                        f"{rel:.3e}, a second call bit-identical, device time "
                        f"of the two kernels {dev_ms:.4f} ms; library none (composition: plain "
                        f"pre_transform + SDPA, TF32 off: {comp_ms:.4f} ms)")
                nbytes += 2 * x["cos"].numel() * 4 + 2 * dh * 4
        table.add(key, text, abs_err, f"rel tol {tol}", ms, time_ms(plain, reps=3), flops,
                  nbytes, library, peak=PEAK_FP32_FLOPS, exps=exps)
        del x, kernel, plain, q, k, v
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def md17_wide_bf16_checks(dev, seed: int, table: KernelTable) -> None:
    """bf16 K5 (with its lse) and K6 at the MD17 stage-2 DiT's 2 x 128 shapes
    at B = 64, which the training and the val hook of phase 14's 2 x 128 run
    give them: the spatial axis [1920, 2, 192, 128] and the temporal one
    [12288, 2, 30, 128], q/k/v head-major views of packed buffers; against
    the plain versions with K1's limits, K5's lse limit at dh 128 and
    K6_REL_TOL, each beside the composition of the plain pre_transform and
    PyTorch's attention."""
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr

    bf, dh, h = torch.bfloat16, 128, MD17_WIDE_HEADS
    gen = torch.Generator(device=dev).manual_seed(seed)
    for b, n in ((MD17_BATCH * MD17_T, MD17_LATENTS), (MD17_BATCH * MD17_LATENTS, MD17_T)):
        qkv = (2 * torch.randn(b, n, 3 * h * dh, generator=gen, device=dev)).to(bf)
        q, k, v = (t.transpose(1, 2) for t in qkv.unflatten(-1, (3, h, dh)).unbind(2))
        g = torch.randn(b, h, n, dh, generator=gen, device=dev).to(bf)
        qs, ks = (1 + 0.2 * torch.randn(dh, generator=gen, device=dev) for _ in range(2))
        cos, sin = rope_cos_sin(n, dh, device=dev)
        scale = dh ** -0.5

        def pre(q_, k_):
            return fnr.pre_transform(q_, k_, qs, ks, cos, sin)

        before = k5_counts()
        out, lse = fnr._forward(q, k, v, qs, ks, cos, sin, scale, with_lse=True)
        launched = tuple(a - c for a, c in zip(k5_counts(), before))
        check(launched == (1, 1, 1, 0, 0, 0), f"K5 MD17 2x128 n={n}: launches {launched}")
        want, want_lse = fa.reference_attention(*pre(q, k), v, scale, return_lse=True)
        torch.cuda.synchronize()
        abs_err, _, atol, k1_gain = k1_errors(out, want)
        lse_err = (lse - want_lse).abs().max().item()
        del want, want_lse
        check_k1(abs_err, atol, k1_gain, f"K5 MD17 2x128 n={n}")
        check(lse_err <= LSE_ATOL["K5"][dh], f"K5 MD17 2x128 n={n} lse err {lse_err}")
        shape = f"[{b},{h},{n},{dh}]"
        attn_flops, attn_bytes = 4 * b * h * n * n * dh, 4 * b * h * n * dh * 2
        table.add(f"K5 MD17 2x128 {shape}", f"raw q/k/v {shape} strided views, with lse (max_abs"
                  f"_err {lse_err:.3e}, atol {LSE_ATOL['K5'][dh]}), gain {k1_gain:.7f}; library "
                  f"none (composition: plain pre_transform + SDPA: "
                  f"{library_times(q, k, v, scale, pre=pre):.4f} ms)", abs_err,
                  f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fnr._forward(q, k, v, qs, ks, cos, sin, scale, with_lse=True),
                          reps=10),
                  time_ms(lambda: fa.reference_attention(*pre(q, k), v, scale, return_lse=True),
                          reps=3),
                  attn_flops, attn_bytes + b * h * n * 4, exps=b * h * n * n)
        args = (q, k, v, qs, ks, cos, sin, out, lse, g, scale)
        before = k6_counts()
        got = fnr.flash_attention_normrope_backward(*args)
        torch.cuda.synchronize()
        launched = tuple(a - c for a, c in zip(k6_counts(), before))
        check(launched == (1, 1, 3, 0, 0, 0), f"K6 MD17 2x128 n={n}: launches {launched}")
        want = fnr.reference_normrope_backward(*args)
        errs = _grad_errors(got, want)
        del got, want
        detail = ", ".join(f"{nm} rel {r:.3e} gain {gn:.7f}"
                           for nm, (_, r, gn) in zip(("dq", "dk", "dv"), errs))
        for nm, (_, rel, gn) in zip(("dq", "dk", "dv"), errs):
            check(rel <= K6_REL_TOL, f"K6 MD17 2x128 n={n} {nm} rel err {rel} > {K6_REL_TOL}")
            check(abs(gn - 1) <= K1_GAIN_TOL, f"K6 MD17 2x128 n={n} {nm} gain {gn}")
        comp_ms = library_times(q, k, v, scale, grad=g, pre=pre)
        table.add(f"K6 MD17 2x128 {shape}", f"q/k/v/dO {shape} strided views, transform kernel "
                  f"+ sm90 backward; {detail}; library none (composition: plain pre_transform + "
                  f"SDPA fwd+bwd - fwd: {comp_ms:.4f} ms)", max(e[0] for e in errs),
                  f"rel tol {K6_REL_TOL} per grad, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fnr.flash_attention_normrope_backward(*args), reps=5),
                  time_ms(lambda: fnr.reference_normrope_backward(*args), reps=2),
                  2.5 * attn_flops, 8 * b * h * n * dh * 2 + b * h * n * 4, exps=b * h * n * n)
        del qkv, q, k, v, g, out, lse, args
        torch.cuda.empty_cache()


# K9-fp32 (csrc/short_attention_f32.cu, f32_fwd_plan / f32_bwd_plan) at its
# tiles' edges, beyond the main-path rows: (b, n, heads, dh, misaligned),
# q/k/v views of one buffer one column wider where misaligned (4-byte
# copies in place of 16-byte ones)
K9_F32_EDGE_SPECS = (
    (256, 127, 4, 64, False),  # [256,127,256]: one head an item, the backward's two chunks
    (4096, 16, 4, 8, False),   # the 4AA smoke width's n = 16, at a batch that fills the card
    (7, 9, 3, 24, True),       # the shortest axis
    (5, 31, 11, 20, True),     # uneven head groups, dh 20
    (4, 33, 2, 16, False),     # past 32 keys
    (6, 65, 3, 12, True),      # past 64: a row a thread, two query chunks
    (2, 127, 4, 5, True))      # dh 5, padded to 8


def k9_f32_edge_checks(dev) -> None:
    """K9-fp32's forward and backward at K9_F32_EDGE_SPECS against their
    plain versions with TF32 off, within F32_REL_TOL["K9 fp32"] and
    K9_F32_GRAD_REL_TOL: one launch a call, a second call bit-identical."""
    from lam_slide_tpu_torch.ops import short_attention as tsa

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    for b, n, heads, dh, misaligned in K9_F32_EDGE_SPECS:
        d, scale = heads * dh, dh ** -0.5
        qkv = torch.randn(b, n, 3 * d + misaligned, generator=gen, device=dev)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d + misaligned:]
        g = torch.randn(b, n, d, generator=gen, device=dev)
        before = (tsa.fp32_launches, tsa.bwd_fp32_launches)
        out, again = tsa.short_attention(q, k, v, heads), tsa.short_attention(q, k, v, heads)
        grads = tsa.short_attention_backward(q, k, v, g, heads, scale)
        grads_again = tsa.short_attention_backward(q, k, v, g, heads, scale)
        launched = (tsa.fp32_launches - before[0], tsa.bwd_fp32_launches - before[1])
        key = f"K9 fp32 [{b},{n},{d}] {heads} x dh {dh}{' misaligned' if misaligned else ''}"
        check(launched == (2, 2), f"{key}: launches {launched} != (2, 2)")
        check(torch.equal(out, again) and _bit_identical(grads, grads_again),
              f"{key}: a second call differs")
        rel = errors(out, tsa.reference_short_attention(q, k, v, heads, scale))[1]
        rels = [e[1] for e in _grad_errors(grads, tsa.reference_short_backward(q, k, v, g, heads,
                                                                                 scale))]
        check(rel <= F32_REL_TOL["K9 fp32"] and max(rels) <= K9_F32_GRAD_REL_TOL,
              f"{key}: rel err forward {rel}, backward {rels}")
        print(f"kernel {key}: forward rel {rel:.3e} (tol {F32_REL_TOL['K9 fp32']}), backward "
              f"dq/dk/dv rel {' / '.join(f'{r:.3e}' for r in rels)} (tol "
              f"{K9_F32_GRAD_REL_TOL}); second calls bit-identical")
        del qkv, q, k, v, g, out, again, grads, grads_again
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32_train_kernel_checks(dev, table: KernelTable) -> None:
    """The fp32 backward kernels that fp32 training runs, against their plain
    versions with TF32 off, on inputs from a card generator: K9-fp32's
    backward at MD17's [12288, 30, 256] (16 x dh 16) and the smoke DiTs'
    4 x dh 8 over n 30 and 16; K4-fp32's narrow kernel at the 4AA fp32
    step's [32, 16, 1000, 24] and ragged at dh 20; its wide kernel at dh 128 at
    the 4AA fp32 DiT's [16, 3, 1000, 128] and MD17's [1920, 2, 192, 128] and
    [12288, 2, 30, 128] (two sequences a block), and ragged at dh 96; K6 in
    fp32 at [16, 3, 1000, 128], the kernel backward and the whole autograd
    chain; K8-fp32's grads through ``_SpatialBlock`` at the 4AA train step's
    [16000, 2, 384] at both splits. Each row: launches, a second call
    bit-identical, the limit, and for the timed rows the kernel's time, the
    plain version's, the bound (five products at fp32's rate, each input
    read and each grad written once, one exponential a score) and SDPA's
    fp32 forward + backward less forward."""
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
    from lam_slide_tpu_torch.ops import short_attention as tsa

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    # K9-fp32's backward: q/k/v packed views of one qkv buffer, as the DiT's
    # temporal block hands them over
    for key, b, n, heads, dh, timed in (
            ("K9 fp32 bwd", MD17_BATCH * 192, MD17_T, 16, 16, True),
            ("K9 fp32 bwd smoke MD17", 4 * 8, 30, 4, 8, False),
            ("K9 fp32 bwd smoke 4AA", 2 * 2, 16, 4, 8, False)):
        qkv = torch.randn(b, n, 3 * heads * dh, generator=gen, device=dev)
        q, k, v = qkv.chunk(3, dim=-1)
        g = torch.randn(b, n, heads * dh, generator=gen, device=dev)
        scale = dh ** -0.5
        before = (tsa.bwd_launches, tsa.bwd_fp32_launches)
        got = tsa.short_attention_backward(q, k, v, g, heads, scale)
        launched = (tsa.bwd_launches - before[0], tsa.bwd_fp32_launches - before[1])
        again = tsa.short_attention_backward(q, k, v, g, heads, scale)
        want = tsa.reference_short_backward(q, k, v, g, heads, scale)
        check(launched == (1, 1), f"{key}: launches {launched} != (1, 1)")
        check(_bit_identical(got, again), f"{key}: a second call differs")
        errs = _grad_errors(got, want)
        worst = max(e[1] for e in errs)
        detail = ", ".join(f"{nm} rel {r:.3e}" for nm, (_, r, _) in zip(("dq", "dk", "dv"), errs))
        shape = f"[{b},{n},{heads * dh}] {heads} x dh {dh}"
        check(worst <= K9_F32_GRAD_REL_TOL, f"{key} rel err {worst} > {K9_F32_GRAD_REL_TOL}")
        if not timed:
            print(f"kernel {key} {shape}: {detail} (rel tol {K9_F32_GRAD_REL_TOL}); a second "
                  f"call bit-identical")
            continue
        heads_view = [t.unflatten(-1, (heads, dh)).transpose(1, 2) for t in (q, k, v, g)]
        table.add(key, f"fp32 packed q/k/v views {shape}: {detail}, a second call "
                  f"bit-identical; library: SDPA fwd+bwd - fwd on fp32 head-major views",
                  max(e[0] for e in errs), f"rel tol {K9_F32_GRAD_REL_TOL} per grad",
                  time_ms(lambda: tsa.short_attention_backward(q, k, v, g, heads, scale),
                          reps=10),
                  time_ms(lambda: tsa.reference_short_backward(q, k, v, g, heads, scale),
                          reps=3),
                  10 * b * heads * n * n * dh, 7 * q.numel() * 4,
                  library_times(*heads_view[:3], scale, grad=heads_view[3]),
                  peak=PEAK_FP32_FLOPS, exps=b * heads * n * n)
        del qkv, q, k, v, g, got, again, want, heads_view
    torch.cuda.empty_cache()

    # K4-fp32 at dh <= 64 (the narrow kernel) at the 4AA fp32 step's temporal
    # axis and ragged at dh 20 (4-byte copies, dh padded to 24); at
    # 64 < dh <= 128 (the wide kernel and its dQ shares' sum) and K6-fp32 on it
    for key, kind, b, h, nq, nk, dh, timed in (
            ("K4 fp32 [32,16,1000,24]", "K4", TRAIN_BATCH * L, HEADS, T, T, HIDDEN // HEADS,
             True),
            ("K4 fp32 dh20 ragged [3,2,130->257,20]", "K4", 3, 2, 130, 257, 20, False),
            ("K4 fp32 dh128", "K4", 1920, 2, 192, 192, 128, True),
            ("K4 fp32 dh128 [12288,2,30,128]", "K4", 12288, 2, 30, 30, 128, True),
            ("K4 fp32 dh128 [16,3,1000,128]", "K4", 16, 3, 1000, 1000, 128, True),
            ("K4 fp32 dh96 ragged [3,2,130->257,96]", "K4", 3, 2, 130, 257, 96, False),
            ("K6 fp32", "K6", 16, 3, 1000, 1000, 128, True)):
        spec = (key, "K1" if kind == "K4" else "K5", b, h, nq, nk, dh, True, False, True)
        x = dh128_inputs(dev, spec, SEED + 13)
        q, k, v = x["q"], x["k"], x["v"]
        scale = dh ** -0.5
        g = torch.randn(b, h, nq, dh, generator=gen, device=dev)
        if kind == "K4":
            out, lse = fa._forward(q, k, v, scale, with_lse=True)
            args = (q, k, v, out, lse, g, scale)

            def kernel():
                return fa.flash_attention_backward(*args)

            def plain():
                return fa.reference_flash_backward(*args)

            def counts():
                return (fa.bwd_kv_launches, fa.bwd_fp32_launches, fa.bwd_fp32_wide_launches,
                        fa.bwd_sm90_launches)

            kernels = k4_f32_kernels(dh, nq, nk)
            want_launched = (1, kernels, kernels if dh > 64 else 0, 0)
            library = lambda: library_times(q, k, v, scale, grad=g)
        else:
            tr = (x["qs"], x["ks"], x["cos"], x["sin"])
            out, lse = fnr._forward(q, k, v, *tr, scale, with_lse=True)
            args = (q, k, v, *tr, out, lse, g, scale)

            def kernel():
                return fnr.flash_attention_normrope_backward(*args)

            def plain():
                return fnr.reference_normrope_backward(*args)

            def counts():
                return (fnr.bwd_launches, fnr.bwd_fp32_launches, fnr.bwd_fp32_wide_launches,
                        fnr.bwd_sm90_launches, fa.bwd_kv_launches)

            kernels = k4_f32_kernels(dh, nq, nk)
            want_launched = (1, kernels, kernels, 0, 0)
            library = lambda: library_times(q, k, v, scale, grad=g,
                                            pre=lambda q_, k_: fnr.pre_transform(q_, k_, *tr))
        before = counts()
        got = kernel()
        launched = tuple(a - c for a, c in zip(counts(), before))
        again = kernel()
        want = plain()
        check(launched == want_launched, f"{key}: launches {launched} != {want_launched}")
        check(_bit_identical(got, again), f"{key}: a second call differs")
        tol = K6_F32_REL_TOL if kind == "K6" else K4_F32_REL_TOL
        errs = _grad_errors(got, want)
        worst = max(e[1] for e in errs)
        names = ("dq", "dk", "dv") if kind == "K4" else ("dq_t", "dk_t", "dv")
        detail = ", ".join(f"{nm} rel {r:.3e}" for nm, (_, r, _) in zip(names, errs))
        check(worst <= tol, f"{key} rel err {worst} > {tol}")
        del got, again, want
        extra = ""
        if kind == "K6":
            # the whole chain: K5-fp32 + K6-fp32 under autograd against
            # autograd of the plain version, grads of q, k, v and both scales
            grads = {}
            for path in ("kernel", "plain"):
                leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, *tr[:2])]
                fn = (fnr.flash_attention_normrope if path == "kernel"
                      else fnr.reference_attention_normrope)
                fn(*leaves, *tr[2:], scale=scale).backward(g)
                grads[path] = [t.grad for t in leaves]
            chain = max(errors(a, w)[1] for a, w in zip(grads["kernel"], grads["plain"]))
            check(chain <= K6_F32_REL_TOL, f"{key} autograd chain rel err {chain}")
            extra = (f"; K5-fp32 + K6-fp32 under autograd vs autograd of the plain version, "
                     f"grads of q, k, v and both scales: worst rel {chain:.3e}")
            del grads, leaves
        shape = f"[{b},{h},{nq}->{nk},{dh}]" if nq != nk else f"[{b},{h},{nq},{dh}]"
        if not timed:
            print(f"kernel {key} {shape}: {detail} (rel tol {tol}); a second call "
                  f"bit-identical{extra}")
            del x, q, k, v, g, out, lse, args
            torch.cuda.empty_cache()
            continue
        plan = fa.f32_wide_plan(nq, nk) if dh > 64 else fa.f32_narrow_plan(dh, nq, nk, b * h)
        nbytes = 4 * (4 * b * h * nq * dh + 4 * b * h * nk * dh + b * h * nq)
        what = ("narrow kernel" if dh <= 64 else "wide kernel" if kind == "K4" else
                "the fp32 transform, then K4-fp32's wide kernel on q_t/k_t")
        lib_text = ("SDPA fwd+bwd - fwd on the fp32 head-major views" if kind == "K4" else
                    "none (composition: plain pre_transform + SDPA fwd+bwd - fwd)")
        table.add(key, f"fp32 q/k/v/dO {shape} strided views, {what} (plan {plan}): {detail}, "
                  f"a second call bit-identical{extra}; library: {lib_text} (TF32 off)",
                  max(e[0] for e in errs), f"rel tol {tol} per grad", time_ms(kernel, reps=5),
                  time_ms(plain, reps=2), 10 * b * h * nq * nk * dh, nbytes, library(),
                  peak=PEAK_FP32_FLOPS, exps=b * h * nq * nk)
        del x, q, k, v, g, out, lse, args
        torch.cuda.empty_cache()

    # K8-fp32 under autograd: the kernel's forward, the plain VJP backward
    for heads in (HEADS, WIDE_HEADS):
        key = f"K8 fp32 grad {heads}x{HIDDEN // heads}"
        n, d, m = TRAIN_BATCH * T, HIDDEN, int(HIDDEN * MLP_RATIO)
        dh = d // heads
        cos, sin = rope_cos_sin(L, dh, device=dev)
        base = [torch.randn(n, L, d, generator=gen, device=dev),
                torch.randn(3 * d + m, d, generator=gen, device=dev) * d ** -0.5,
                torch.randn(3 * d + m, generator=gen, device=dev) * 0.1,
                1 + 0.2 * torch.randn(dh, generator=gen, device=dev),
                1 + 0.2 * torch.randn(dh, generator=gen, device=dev),
                torch.randn(d, d + m, generator=gen, device=dev) * (d + m) ** -0.5,
                torch.randn(d, generator=gen, device=dev) * 0.1]
        g = torch.randn(n, L, d, generator=gen, device=dev)

        def fwd_bwd(fn):
            leaves = [t.detach().requires_grad_() for t in base]
            out = fn(*leaves, cos, sin, heads, dh ** -0.5)
            out.backward(g)
            return out.detach(), [t.grad for t in leaves]

        before = (fsb.launches, fsb.f32_launches)
        got_out, got = fwd_bwd(fsb.fused_spatial_block)
        launched = (fsb.launches - before[0], fsb.f32_launches - before[1])
        want_out, want = fwd_bwd(fsb.reference_spatial_block)
        check(launched == (1, 1), f"{key}: launches {launched} != (1, 1)")
        out_rel = errors(got_out, want_out)[1]
        worst = max(errors(a, w)[1] for a, w in zip(got, want))
        check(all(bool(torch.isfinite(t).all()) for t in got), f"{key}: a non-finite grad")
        check(max(out_rel, worst) <= K8_F32_GRAD_REL_TOL,
              f"{key}: out rel {out_rel}, worst grad rel {worst} > {K8_F32_GRAD_REL_TOL}")
        ms = time_ms(lambda: fwd_bwd(fsb.fused_spatial_block), reps=5)
        plain_ms = time_ms(lambda: fwd_bwd(fsb.reference_spatial_block), reps=3)
        print(f"kernel {key} [{n},{L},{d}] fp32 forward + backward through _SpatialBlock (the "
              f"kernel's forward, the plain VJP): out rel {out_rel:.3e}, worst grad rel "
              f"{worst:.3e} of x, w1, b1, both scales, w2, b2 (rel tol {K8_F32_GRAD_REL_TOL}); "
              f"kernel path {ms:.4f} ms, plain forward + backward {plain_ms:.4f} ms")
        del base, g, got, want, got_out, want_out
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def md17_train_kernel_checks(dev, gen, table: KernelTable) -> None:
    """K1-fp32's lse and K4 with the key-padding bias (fp32 and bf16) and with
    fp32 operands against the plain versions at the MD17 training shapes:
    stage 1's encoder cross-attention [256, 8, 192 -> 32, 16] with the bias
    and its latent self-attention [256, 2, 192, 16], the stage-2 aux decode's
    self-attention [1920, 2, 192, 16]; and ragged [3, 3, 130, 257, 24] with an
    all-masked row. Table rows K4 bias (the encoder's, fp32) and K4 fp32 (the
    aux decode's)."""
    from lam_slide_tpu_torch.ops import flash_attention as fa

    f32, bf, dh = torch.float32, torch.bfloat16, 16
    cases = (("K4 bias", MD17_S1_BATCH, 8, 192, MD17_ATOMS, dh, f32),
             ("K4 bias bf16", MD17_S1_BATCH, 8, 192, MD17_ATOMS, dh, bf),
             ("K4 fp32 stage 1", MD17_S1_BATCH, 2, 192, 192, dh, f32),
             ("K4 fp32", MD17_BATCH * MD17_T, 2, 192, 192, dh, f32),
             ("K4 fp32 [1920,16,192,16]", MD17_BATCH * MD17_T, MD17_HEADS, 192, 192, dh, f32),
             ("K4 bias fp32 ragged", 3, 3, 130, 257, 24, f32),
             ("K4 bias bf16 ragged", 3, 3, 130, 257, 24, bf))
    for key, b, h, nq, nk, hd, dtype in cases:
        # q a view of to_q's output, k/v views of to_kv's, as Attention makes them
        q = _rand(gen, b, nq, h * hd).to(dev, dtype).unflatten(-1, (h, hd)).transpose(1, 2)
        k, v = (t.transpose(1, 2) for t in _rand(gen, b, nk, 2 * h * hd).to(dev, dtype)
                .unflatten(-1, (2, h, hd)).unbind(2))
        g = _rand(gen, b, h, nq, hd).to(dev, dtype)
        mask = (None if "bias" not in key else _key_mask(gen, b, nk, dev) if "ragged" in key
                else _atom_mask(gen, b, dev))
        bias = None if mask is None else fa.mask_to_bias(mask)
        scale = hd ** -0.5
        out, lse = fa._forward(q, k, v, scale, with_lse=True, mask=mask)
        _, want_lse = fa.reference_attention(q, k, v, scale, return_lse=True, mask=mask)
        args = (q, k, v, out, lse, g, scale)
        got = fa.flash_attention_backward(*args, mask=mask)
        want = fa.reference_flash_backward(*args, bias)
        torch.cuda.synchronize()
        fp32 = dtype == f32
        if fp32:
            check(_bit_identical(got, fa.flash_attention_backward(*args, mask=mask)),
                  f"{key}: a second call differs")
        lse_err = (lse - want_lse).abs().max().item()
        lse_atol = LSE_F32_ATOL if fp32 else LSE_ATOL["K1"][24]
        rel_tol = K4_F32_REL_TOL if fp32 else K4_REL_TOL
        errs = _grad_errors(got, want)
        detail = ", ".join(f"{n} rel {r:.3e} gain {gn:.7f}"
                           for n, (_, r, gn) in zip(("dq", "dk", "dv"), errs))
        print(f"kernel {key} [{b},{h},{nq},{nk},{hd}] {str(dtype)[6:]}: {detail} (rel tol "
              f"{rel_tol}); K1 lse max_abs_err {lse_err:.3e} (atol {lse_atol})"
              f"{'; a second call bit-identical' if fp32 else ''}")
        check(lse_err <= lse_atol, f"K1 lse err {lse_err} > {lse_atol} at {key}")
        for name, (_, rel, gn) in zip(("dq", "dk", "dv"), errs):
            check(rel <= rel_tol, f"{key} {name} rel err {rel} > {rel_tol}")
            check(abs(gn - 1) <= K1_GAIN_TOL, f"{key} {name} gain {gn} off 1 by > {K1_GAIN_TOL}")
        if key in ("K4 bias", "K4 fp32", "K4 fp32 [1920,16,192,16]"):
            # five products (2.5x the forward's FLOPs) at fp32's rate; q, out,
            # dO, dq and k, v, dk, dv once in fp32, lse and the bias row once
            nbytes = 4 * (4 * b * h * nq * hd + 4 * b * h * nk * hd + b * h * nq
                          + (0 if mask is None else b * nk))
            table.add(key, f"fp32 q/k/v/dO [{b},{h},{nq}->{nk},{hd}] strided views"
                      f"{', bias' if mask is not None else ''}", max(e[0] for e in errs),
                      f"rel tol {rel_tol} per grad, gain tol {K1_GAIN_TOL}",
                      time_ms(lambda: fa.flash_attention_backward(*args, mask=mask), reps=10),
                      time_ms(lambda: fa.reference_flash_backward(*args, bias), reps=3),
                      2.5 * 4 * b * h * nq * nk * hd, nbytes,
                      library_times(q, k, v, scale, grad=g, mask=mask), peak=PEAK_FP32_FLOPS,
                      exps=b * h * nq * nk)
        del got, want
    torch.cuda.empty_cache()


def ped_nba_kernel_checks(dev, table: KernelTable, seed: int = SEED + 17) -> None:
    """K8, K9 (forward and backward), K2 and K7 against their plain versions
    at the shapes the pedestrian and NBA stage-2 DiTs give them at the
    registries' B (PN_SHAPES): the bf16 training DiT and one repeat of the
    fp32 test pass (TF32 off), which share their shapes. K8 on x [B*T, L, D]
    (the Hopper kernel in bf16; in fp32 the outer-product kernel, as
    ``f32_plan`` gives these widths, bit-identical to the dot-product route
    launched directly); K9 on packed q/k/v views of one linear1 output
    [B*L, T, 3D] and its backward; K2 on the temporal MLP branch's B*T*L
    rows (in fp32 the outer-product kernel, bit-identical to the
    dot-product route); K7 on the [B, T, L, D] stream. Each: its counters, a
    second call bit-identical, the limit of its dtype's rows above, its time
    beside the plain version's, the bound and SDPA (K9), or the PyTorch
    composition (K2, K7; the two bare GEMMs of its shapes for K8) where no
    one call computes the function. Then K8-fp32's dot-product route at a
    width it still takes (``k8_f32_dot_check``). Printed rows only: the
    ``kernels`` line keeps its shapes. Inputs from a card generator seeded
    with ``seed``."""
    from torch.nn.functional import gelu, linear

    from lam_slide_tpu_torch.ops import _build
    from lam_slide_tpu_torch.ops import fused_adaln as fad
    from lam_slide_tpu_torch.ops import fused_mlp as fm
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
    from lam_slide_tpu_torch.ops import short_attention as tsa

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for workload, (b, d, heads, l, _) in PN_SHAPES.items():
        m, dh, t = 2 * d, d // heads, PN_T
        frames, seqs, rows = b * t, b * l, b * t * l
        for dtype in (torch.bfloat16, torch.float32):
            fp32 = dtype == torch.float32
            tag, peak, es = ("fp32", PEAK_FP32_FLOPS, 4) if fp32 else ("bf16", PEAK_BF16_FLOPS, 2)
            fp = " fp32" if fp32 else ""

            # K8 over the L latents of each frame
            w1, b1 = randn(3 * d + m, d, scale=d ** -0.5), randn(3 * d + m, scale=0.1)
            w2, b2 = randn(d, d + m, scale=(d + m) ** -0.5), randn(d, scale=0.1)
            x = randn(frames, l, d)
            args8 = k8_args(dev, torch.Generator().manual_seed(seed), *(
                z.to(dtype) for z in (x, w1, b1, w2, b2)), heads)
            names = ("launches", "f32_launches", "wmma_launches", "f32_tiled_launches",
                     "f32_dot_launches")
            before = [getattr(fsb, name) for name in names]
            got, again = fsb.fused_spatial_block(*args8), fsb.fused_spatial_block(*args8)
            want = fsb.reference_spatial_block(*args8)
            torch.cuda.synchronize()
            launched = tuple(getattr(fsb, name) - n for name, n in zip(names, before))
            key = f"K8{fp} {workload} [{frames},{l},{d}] {heads}x{dh}"
            check(launched == ((2, 2, 0, 2, 0) if fp32 else (2, 0, 0, 0, 0)),
                  f"{key}: launches {launched} of (K8, fp32, WMMA, outer-product, "
                  f"dot-product) for two calls")
            check(torch.equal(got, again), f"{key}: a second call differs")
            tol = PEP_F32_REL_TOL["K8 fp32"] if fp32 else K8_REL_TOL
            abs_err, rel = errors(got, want)
            check(rel <= tol, f"{key} rel err {rel} > {tol}")
            plan = fsb.f32_plan(frames, l, d, m, heads) if fp32 else None
            if fp32:
                # the dot-product route on the same inputs sums in the same order
                dot = fsb._launch_f32_dot(*args8)
                torch.cuda.synchronize()
                check(torch.equal(got, dot), f"{key}: the outer- and dot-product kernels differ")
                del dot
            del got, again, want
            a8, wd1, bd1, wd2, bd2 = args8[0], args8[1], args8[2], args8[5], args8[6]
            mid = torch.empty(frames * l, d + m, device=dev, dtype=dtype)
            gemms = time_ms(lambda: (linear(a8.view(-1, d), wd1, bd1), linear(mid, wd2, bd2)))
            route = (f"the outer-product kernel (plan: group {plan.group}, {plan.rows} rows a "
                     f"block, {plan.blocks} blocks, {plan.smem} B), bit-identical to the "
                     f"dot-product route" if fp32 else "the Hopper kernel")
            table.add(key, f"x [{frames},{l},{d}] {tag}, heads {heads} x {dh}, {route}, rel "
                      f"{rel:.3e}, a second call bit-identical; library: none (the two bare "
                      f"cuBLAS GEMMs of its shapes {gemms:.4f} ms)", abs_err, f"rel tol {tol}",
                      time_ms(lambda: fsb.fused_spatial_block(*args8)),
                      time_ms(lambda: fsb.reference_spatial_block(*args8), reps=5),
                      2 * frames * l * (d * (3 * d + m) + (d + m) * d),
                      es * (2 * frames * l * d + (3 * d + m) * (d + 1) + d * (d + m + 1)),
                      peak=peak)
            del args8, a8, wd1, bd1, wd2, bd2, mid, x

            # K9 on the temporal axis: packed views of one linear1 output
            q, k, v = randn(seqs, t, 3 * d).to(dtype).chunk(3, -1)
            g = randn(seqs, t, d).to(dtype)
            scale = dh ** -0.5
            counters = ("fp32_launches", "bwd_fp32_launches") if fp32 else ("launches",
                                                                            "bwd_launches")
            before = [getattr(tsa, c) for c in counters]
            got, again = tsa.short_attention(q, k, v, heads), tsa.short_attention(q, k, v, heads)
            want = tsa.reference_short_attention(q, k, v, heads, scale)
            bwd, bwd_again = (tsa.short_attention_backward(q, k, v, g, heads, scale)
                              for _ in range(2))
            bwd_want = tsa.reference_short_backward(q, k, v, g, heads, scale)
            torch.cuda.synchronize()
            key = f"K9{fp} {workload} [{seqs},{t},{d}] {heads}x{dh}"
            launched = tuple(getattr(tsa, c) - n for c, n in zip(counters, before))
            check(launched == (2, 2), f"{key}: forward / backward launches {launched} for two "
                  f"calls each")
            check(torch.equal(got, again) and _bit_identical(bwd, bwd_again),
                  f"{key}: a second call differs")
            if fp32:
                abs_err, rel = errors(got, want)
                check(rel <= F32_REL_TOL["K9 fp32"], f"{key} rel err {rel}")
                fwd_note, fwd_tol = f"rel {rel:.3e}", f"rel tol {F32_REL_TOL['K9 fp32']}"
            else:
                abs_err, _, atol, k1_gain = k1_errors(got, want)
                check_k1(abs_err, atol, k1_gain, key)
                fwd_note = f"gain {k1_gain:.7f}"
                fwd_tol = f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}"
            errs = _grad_errors(bwd, bwd_want)
            bwd_tol = K9_F32_GRAD_REL_TOL if fp32 else K9_GRAD_REL_TOL
            for nm, (_, r, gn) in zip(("dq", "dk", "dv"), errs):
                check(r <= bwd_tol, f"{key} backward {nm} rel err {r} > {bwd_tol}")
                check(fp32 or abs(gn - 1) <= K1_GAIN_TOL, f"{key} backward {nm} gain {gn}")
            detail = ", ".join(f"{nm} rel {r:.3e}" for nm, (_, r, _) in zip(("dq", "dk", "dv"),
                                                                             errs))
            del got, again, want, bwd, bwd_again, bwd_want
            hm = [z.unflatten(-1, (heads, dh)).transpose(1, 2) for z in (q, k, v, g)]
            flops, exps = 4 * seqs * t * t * d, seqs * heads * t * t
            table.add(key, f"packed q/k/v views {tag}, {fwd_note}, a second call bit-identical; "
                      f"library: SDPA on head-major views", abs_err, fwd_tol,
                      time_ms(lambda: tsa.short_attention(q, k, v, heads)),
                      time_ms(lambda: tsa.reference_short_attention(q, k, v, heads, scale), reps=5),
                      flops, 4 * seqs * t * d * es, library_times(*hm[:3], scale), peak=peak,
                      exps=exps)
            table.add(f"K9{fp} bwd {workload} [{seqs},{t},{d}] {heads}x{dh}",
                      f"packed q/k/v/dO views {tag}: {detail}, a second call bit-identical; "
                      f"library: SDPA fwd+bwd - fwd", max(e[0] for e in errs),
                      f"rel tol {bwd_tol} per grad",
                      time_ms(lambda: tsa.short_attention_backward(q, k, v, g, heads, scale)),
                      time_ms(lambda: tsa.reference_short_backward(q, k, v, g, heads, scale),
                              reps=3),
                      2.5 * flops, 7 * seqs * t * d * es,
                      library_times(*hm[:3], scale, grad=hm[3]), peak=peak, exps=exps)
            del q, k, v, g, hm

            # K2: the temporal block's MLP branch over every token
            x2 = randn(rows, d).to(dtype)
            lin1, mb1 = randn(3 * d + m, d, scale=d ** -0.5).to(dtype), randn(m, scale=0.1)
            lin2 = randn(d, d + m, scale=(d + m) ** -0.5).to(dtype)
            mlp = (x2, lin1[3 * d:].t(), mb1.to(dtype), lin2[:, d:].t())
            names = ("launches", "fp32_launches", "fp32_tiled_launches", "fp32_dot_launches",
                     "wmma_launches", "cp_async_launches")
            before = [getattr(fm, name) for name in names]
            got, again, want = fm.fused_mlp(*mlp), fm.fused_mlp(*mlp), fm.reference_mlp(*mlp)
            torch.cuda.synchronize()
            launched = tuple(getattr(fm, name) - n for name, n in zip(names, before))
            route = ("bf16 Hopper" if not fp32 else
                     "outer-product" if fm.tiled_plan(d, m, d, rows) is not None else "dot-product")
            want_launched = {"bf16 Hopper": (2, 0, 0, 0, 0, 0), "outer-product": (2, 2, 2, 0, 0, 0),
                             "dot-product": (2, 2, 0, 2, 0, 0)}[route]
            key = f"K2{fp} {workload} [{rows},{d}]"
            check(launched == want_launched, f"{key}: launches {launched}, not the {route} route")
            check(torch.equal(got, again), f"{key}: a second call differs")
            abs_err, rel = errors(got, want)
            tol = F32_REL_TOL["K2 fp32"] if fp32 else K2_ATOL
            check((rel if fp32 else abs_err) <= tol, f"{key} error {abs_err} (rel {rel}) > {tol}")
            if route == "outer-product":
                # the dot-product route on the same inputs sums in the same order
                dot = torch.empty_like(got)
                w1v, w2v = mlp[1], mlp[3]
                with torch.cuda.device(dev):
                    _build.launch("lam_fused_mlp_f32", x2.data_ptr(), w1v.data_ptr(),
                                  mlp[2].data_ptr(), w2v.data_ptr(), dot.data_ptr(), rows, d, m,
                                  d, x2.stride(0), w1v.stride(1), w2v.stride(1), dot.stride(0),
                                  *fm.f32_plan(d, d), stream)
                torch.cuda.synchronize()
                check(torch.equal(got, dot), f"{key}: the outer- and dot-product kernels differ")
                route += (f" route (plan {fm.tiled_plan(d, m, d, rows)}), bit-identical to the "
                          f"dot-product")
                del dot
            del got, again, want
            comp_ms = time_ms(lambda: linear(gelu(linear(x2, lin1[3 * d:], mlp[2])), lin2[:, d:]),
                              reps=5)
            # fp32: the kernel's device time (the pedestrian call is shorter than 0.1 ms)
            k2_ms = (device_ms(lambda: fm.fused_mlp(*mlp), "mlp_f32") if fp32
                     else time_ms(lambda: fm.fused_mlp(*mlp)))
            table.add(key, f"x [{rows},{d}] -> {m} -> {d} {tag}, transposed nn.Linear views, the "
                      f"{route} route, rel {rel:.3e}, a second call bit-identical; "
                      f"{'time: the kernel device time (profiler); ' if fp32 else ''}library: "
                      f"none (the two-GEMM cuBLAS composition with GELU {comp_ms:.4f} ms)",
                      abs_err, f"{'rel tol' if fp32 else 'atol'} {tol}", k2_ms,
                      time_ms(lambda: fm.reference_mlp(*mlp), reps=3), 4 * rows * d * m,
                      rows * d * (es + 4) + 2 * d * m * es + m * es, peak=peak)
            del x2, lin1, mb1, lin2, mlp

            # K7 on the residual stream, h the transposed temporal output
            x7 = randn(b, t, l, d, scale=3.0).to(dtype)
            h7 = randn(b, l, t, d).to(dtype).transpose(1, 2)
            shift, scale7, gate = randn(b, 1, 1, 6 * d, scale=0.5).to(dtype).chunk(6, -1)[:3]
            ada = (x7, h7, gate, shift, scale7)
            counter = "fp32_launches" if fp32 else "launches"
            before = getattr(fad, counter)
            (x_new, y), (x_again, y_again) = (fad.residual_adaln_modulate(*ada) for _ in range(2))
            want_x, want_y = fad.reference_residual_adaln_modulate(*ada)
            torch.cuda.synchronize()
            key = f"K7{fp} {workload} [{b},{t},{l},{d}]"
            check(getattr(fad, counter) - before == 2, f"{key}: the kernel did not launch once "
                  f"a call")
            check(torch.equal(x_new, want_x), f"{key}: x_new is not bit-identical")
            check(torch.equal(x_new, x_again) and torch.equal(y, y_again),
                  f"{key}: a second call differs")
            abs_err, rel = errors(y, want_y)
            if fp32:
                tol, limit = F32_REL_TOL["K7 fp32"], f"rel tol {F32_REL_TOL['K7 fp32']}"
                check(rel <= tol, f"{key} rel err {rel} > {tol}")
            else:
                atol = K7_ULPS * bf16_ulp(want_y.float().abs().max().item())
                limit = f"atol {atol:.3e} = {K7_ULPS} bf16 ulp at max |y|"
                check(abs_err <= atol, f"{key} y max abs err {abs_err} > {atol}")
            del x_new, y, x_again, y_again, want_x, want_y
            comp_ms = time_ms(lambda: adaln_composition(*ada), reps=5)
            table.add(key, f"x/h [{b},{t},{l},{d}] {tag} (h the transposed temporal view), "
                      f"x_new bit-identical, y rel {rel:.3e}, a second call bit-identical; time: "
                      f"the kernel's device time (profiler); library: none (F.layer_norm + "
                      f"modulate composition {comp_ms:.4f} ms)", abs_err, limit,
                      device_ms(lambda: fad.residual_adaln_modulate(*ada), "adaln"),
                      time_ms(lambda: fad.reference_residual_adaln_modulate(*ada), reps=5),
                      0, es * (4 * rows * d + 3 * b * d), peak=peak)
            del x7, h7, shift, scale7, gate, ada
            torch.cuda.empty_cache()
    k8_f32_dot_check(dev, table, gen)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# K8-fp32's dot-product route at a width it still takes (no outer-product
# instance): the tiny registries' hidden 32 at 4 x 8, M 64, L = 8, over as
# many frames as the NBA test pass's repeat
K8_F32_DOT_SHAPE = (20480, 8, 32, 4)


def k8_f32_dot_check(dev, table: KernelTable, gen) -> None:
    """K8-fp32 on the dot-product route (the first fp32 kernel) at
    K8_F32_DOT_SHAPE, TF32 off: its counters (the dot-product one moves once
    a call), a second call bit-identical, within PEP_F32_REL_TOL["K8 fp32"]
    of the plain version, its time beside the plain version's, the bound
    and the two bare cuBLAS SGEMMs of its shapes. A printed row."""
    from torch.nn.functional import linear

    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb

    n, l, d, heads = K8_F32_DOT_SHAPE
    m, dh = 2 * d, d // heads

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    w1, b1 = randn(3 * d + m, d, scale=d ** -0.5), randn(3 * d + m, scale=0.1)
    w2, b2 = randn(d, d + m, scale=(d + m) ** -0.5), randn(d, scale=0.1)
    args8 = k8_args(dev, torch.Generator().manual_seed(SEED + 21), randn(n, l, d), w1, b1, w2,
                    b2, heads)
    plan = fsb.f32_plan(n, l, d, m, heads)
    check(plan.route == "dot", f"K8 fp32 [{n},{l},{d}]: plan {plan}, not the dot-product route")
    before = (fsb.f32_launches, fsb.f32_tiled_launches, fsb.f32_dot_launches)
    got, again = fsb.fused_spatial_block(*args8), fsb.fused_spatial_block(*args8)
    want = fsb.reference_spatial_block(*args8)
    torch.cuda.synchronize()
    launched = (fsb.f32_launches - before[0], fsb.f32_tiled_launches - before[1],
                fsb.f32_dot_launches - before[2])
    key = f"K8 fp32 dot [{n},{l},{d}] {heads}x{dh}"
    check(launched == (2, 0, 2), f"{key}: launches {launched} of (fp32, outer-product, "
          f"dot-product) for two calls")
    check(torch.equal(got, again), f"{key}: a second call differs")
    tol = PEP_F32_REL_TOL["K8 fp32"]
    abs_err, rel = errors(got, want)
    check(rel <= tol, f"{key} rel err {rel} > {tol}")
    del got, again, want
    rows = n * l
    mid = torch.empty(rows, d + m, device=dev)
    gemms = time_ms(lambda: (linear(args8[0].view(-1, d), w1, b1), linear(mid, w2, b2)))
    table.add(key, f"x [{n},{l},{d}] fp32, heads {heads} x {dh}, the dot-product route (plan: "
              f"group {plan.group}, {plan.blocks} blocks of 32 rows, {plan.smem} B), rel "
              f"{rel:.3e}, a second call bit-identical; library: none (the two bare cuBLAS "
              f"SGEMMs of its shapes {gemms:.4f} ms)", abs_err, f"rel tol {tol}",
              time_ms(lambda: fsb.fused_spatial_block(*args8)),
              time_ms(lambda: fsb.reference_spatial_block(*args8), reps=5),
              2 * rows * (d * (3 * d + m) + (d + m) * d),
              4 * (2 * rows * d + (3 * d + m) * (d + 1) + d * (d + m + 1)), peak=PEAK_FP32_FLOPS)
    del args8, mid
    torch.cuda.empty_cache()


def ablation_kernel_checks(dev, gen, table: KernelTable) -> None:
    """K10 and K11 against their plain versions. K10 on packed q/k/v views
    of a linear1-like buffer [B*L = 16, T = 1000, 384] bf16 with lane tables
    and tiled lane scales, at 3 x 128 (its row) and 16 x 24, and at a ragged
    T with a scale per lane; also against the K5 route and the K3 route on
    the same raw q/k/v. K11 from the out/lse of a K1 forward at the MD17
    stage-2 spatial axis [64*30 = 1920, 16, 192, 16] in bf16, against its
    plain version and against K4's grads, with its peak memory; and in fp32
    at one of the JAX package's test shapes."""
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr
    from lam_slide_tpu_torch.ops.ablations import fused_temporal_attention as tft
    from lam_slide_tpu_torch.ops.ablations import short_backward as tsb
    from lam_slide_tpu_torch.ops.packed_attention import (
        lane_rope_tables,
        packed_rmsnorm,
        packed_rope,
    )

    bf, d, bp = torch.bfloat16, HIDDEN, 8 * L
    for key, n, t, heads, tiled in (("K10", bp, T, WIDE_HEADS, True),
                                    ("K10 16x24", bp, T, HEADS, True),
                                    ("K10 ragged", 3, 1001, HEADS, False)):
        dh = d // heads
        qkv = _rand(gen, n, t, 3 * d, scale=2.0).to(dev, bf)
        q, k, v = qkv.split(d, dim=-1)
        cos, sin = rope_cos_sin(t, dh, device=dev)
        cos_l, sin_l = lane_rope_tables(cos, sin, heads)
        if tiled:
            qs, ks = (1 + 0.2 * _rand(gen, dh)).to(dev), (1 + 0.2 * _rand(gen, dh)).to(dev)
            qs_l, ks_l = qs.repeat(heads)[None], ks.repeat(heads)[None]
        else:
            qs_l, ks_l = ((1 + 0.2 * _rand(gen, 1, d)).to(dev) for _ in range(2))
        args = (q, k, v, cos_l, sin_l, qs_l, ks_l, heads, dh ** -0.5)
        got, want = tft.fused_temporal_attention(*args), tft.reference_fused_temporal(*args)
        torch.cuda.synchronize()
        check(got.shape == q.shape and got.dtype == bf and got.is_contiguous(), f"{key} shape")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        detail = [f"gain {k1_gain:.7f}"]
        if tiled:
            # the K5 route (raw head-major views, [dh] scales and [T, dh/2]
            # tables) and the K3 route (packed norm and RoPE, then K3)
            heads_of = [t_.unflatten(-1, (heads, dh)).transpose(1, 2) for t_ in (q, k, v)]
            via_k5 = fnr.flash_attention_normrope(*heads_of, qs, ks, cos, sin)
            via_k5 = via_k5.transpose(1, 2).flatten(2)
            qn, kn = (packed_rope(packed_rmsnorm(x, heads, s_), cos_l, sin_l)
                      for x, s_ in ((q, qs), (k, ks)))
            via_k3 = fa.flash_attention_packed(qn, kn, v, heads)
            torch.cuda.synchronize()
            for route, other in (("K5", via_k5), ("K3", via_k3)):
                _, rel = errors(got, other)
                g_ = gain(got, other)
                detail.append(f"vs the {route} route rel {rel:.3e} gain {g_:.7f}")
                check(rel <= K10_ROUTE_REL_TOL, f"{key} vs the {route} route rel err {rel}")
                check(abs(g_ - 1) <= K1_GAIN_TOL, f"{key} vs the {route} route gain {g_}")
            del via_k5, via_k3, qn, kn
        # library: none; with tiled scales the composition of the plain
        # pre_transform and SDPA on head-major views, as K5's row has
        library = None
        if tiled:
            heads_of = [t_.unflatten(-1, (heads, dh)).transpose(1, 2) for t_ in (q, k, v)]
            library = library_times(*heads_of, dh ** -0.5, pre=lambda q_, k_: fnr.pre_transform(
                q_, k_, qs, ks, cos, sin))
            detail.append("library: none (the composition pre_transform + SDPA)")
        table.add(key, f"packed q/k/v [{n},{t},{d}] views, {heads} x {dh}, "
                  f"{'tiled' if tiled else 'per-lane'} scales; {'; '.join(detail)}", abs_err,
                  f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}, routes rel "
                  f"tol {K10_ROUTE_REL_TOL}",
                  time_ms(lambda: tft.fused_temporal_attention(*args)),
                  time_ms(lambda: tft.reference_fused_temporal(*args), reps=5),
                  4 * n * t * t * d, 4 * n * t * d * 2 + 2 * t * d * 4 + 2 * d * 4, library,
                  exps=n * heads * t * t)
        check_k1(abs_err, atol, k1_gain, key)
        del got, want
    torch.cuda.empty_cache()

    # K11 at the MD17 stage-2 spatial axis: q/k/v head-major views of packed
    # buffers, out and lse from K1 (K3's binary)
    for key, b, h, n, dh, dtype in (("K11", MD17_BATCH * MD17_T, 16, 192, 16, bf),
                                    ("K11 fp32", 2, 8, 192, 24, torch.float32)):
        qkv = _rand(gen, b, n, 3 * h * dh).to(dev, dtype)
        q, k, v = (t_.transpose(1, 2) for t_ in qkv.unflatten(-1, (3, h, dh)).unbind(2))
        g = _rand(gen, b, h, n, dh).to(dev, dtype)
        scale = dh ** -0.5
        out, lse = fa._forward(q, k, v, scale, with_lse=True)
        args = (q, k, v, out, lse, g, scale)
        torch.cuda.synchronize()
        peaks = {}
        for name, fn in (("K11", tsb.flash_backward_short), ("K4", fa.flash_attention_backward),
                         ("plain", tsb.reference_flash_backward_short)):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            res = fn(*args)
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            if name == "K11":
                got = res
                check(_bit_identical(got, fn(*args)),
                      f"{key}: a second call on the same inputs differs")
            elif name == "K4":
                k4 = res
            else:
                want = res
            del res
        fp32 = dtype == torch.float32
        rel_tol = K4_F32_REL_TOL if fp32 else K4_REL_TOL
        errs, errs4 = _grad_errors(got, want), _grad_errors(got, k4)
        detail = ", ".join(f"{nm} rel {r:.3e} gain {gn:.7f} (vs K4 rel {r4:.3e})"
                           for nm, (_, r, gn), (_, r4, _) in zip(("dq", "dk", "dv"), errs, errs4))
        detail += "; a second call bit-identical"
        for nm, (_, rel, gn), (_, rel4, gn4) in zip(("dq", "dk", "dv"), errs, errs4):
            check(rel <= rel_tol, f"{key} {nm} rel err {rel} > {rel_tol}")
            check(abs(gn - 1) <= K1_GAIN_TOL, f"{key} {nm} gain {gn}")
            check(rel4 <= 2 * rel_tol, f"{key} {nm} vs K4 rel err {rel4} > {2 * rel_tol}")
            check(abs(gn4 - 1) <= 2 * K1_GAIN_TOL, f"{key} {nm} vs K4 gain {gn4}")
        peak = (f"peak memory above the inputs: K11 {peaks['K11']:.1f} MiB, K4 "
                f"{peaks['K4']:.1f} MiB, plain {peaks['plain']:.1f} MiB")
        if fp32:
            print(f"kernel {key} [{b},{h},{n},{dh}] fp32: {detail} (rel tol {rel_tol}); {peak}")
        else:
            # five products (2.5x the forward's FLOPs); q/k/v/out/dO read and
            # dq/dk/dv written once in bf16, lse read once in fp32
            d_all = h * dh
            table.add(key, f"q/k/v/dO [{b},{h},{n},{dh}] strided views; {detail}; {peak}",
                      max(e[0] for e in errs), f"rel tol {rel_tol} per grad, gain tol "
                      f"{K1_GAIN_TOL}; vs K4 2x", time_ms(lambda: tsb.flash_backward_short(*args),
                                                          reps=10),
                      time_ms(lambda: tsb.reference_flash_backward_short(*args), reps=3),
                      2.5 * 4 * b * n * n * d_all, 8 * b * n * d_all * 2 + b * h * n * 4,
                      library_times(q, k, v, scale, grad=g), exps=b * h * n * n)
            k4_ms = time_ms(lambda: fa.flash_attention_backward(*args), reps=10)
            print(f"kernel K4 at K11's shape: {k4_ms:.4f} ms")
        del got, want, k4, args, out, lse, qkv, q, k, v, g
        torch.cuda.empty_cache()


def md17_first_run(dev):
    """MD17 stage 1 through the port's registry (experiments/registry.py:
    155-193): fp32, 32 padded atoms, B=256, AdamW lr 4e-4; random weights
    from the seed, synthetic trajectories of MD17_FRAMES frames for each of
    the 8 molecules."""
    from lam_slide_tpu_torch.experiments import registry

    return registry.md17_first_stage(seed=SEED, synthetic_frames=MD17_FRAMES, device=dev)


def md17_second_run(run1, dev):
    """MD17 stage 2 on ``run1``'s first stage, which it freezes
    (registry.py:196-300): the bf16 class-conditional DiT (depth 4, hidden
    256, 16 x dh 16), B=64, per-layer checkpointing, the aux losses on, lr
    1e-3, EMA 0.999, the sampled val hook."""
    from lam_slide_tpu_torch.experiments import registry

    return registry.md17_second_stage(first_stage=run1, seed=SEED,
                                      synthetic_frames=MD17_FRAMES, device=dev)


def md17_phase(dev, smi, reset_counts, read_counts):
    """Phase 9; returns the launches of one protocol batch. The stages come
    from the registry and the batch from its aspirin val
    loader: 64 windows of 30 frames, 21 atoms padded to 32."""
    from lam_slide_tpu_torch.composites.evaluation import mean_over_k_ade_fde, zero_target_frames
    from lam_slide_tpu_torch.composites.testing import evaluate_md17
    from lam_slide_tpu_torch.data.loader import device_batch
    from lam_slide_tpu_torch.nn.blocks import set_backend

    run1 = md17_first_run(dev)
    run2 = md17_second_run(run1, dev)
    cfg1, ss = run1.config, run2.second_stage
    batch = device_batch(next(iter(run2.val_loaders["aspirin"])), dev)
    check(batch["pos"].shape == (MD17_BATCH, MD17_T, MD17_ATOMS, 3),
          f"MD17 val batch {tuple(batch['pos'].shape)}")
    cond_end = ss.cond_idx[1]
    euler = {"sampling_method": "euler", "num_steps": NUM_STEPS}

    def set_all(backend):
        set_backend(ss.backbone, backend)
        set_backend(ss.first_stage, backend)

    # one protocol batch through evaluate_md17, the launches per kernel
    with torch.no_grad():
        reset_counts()
        metrics = evaluate_md17(ss, {"md17": [batch]}, scale=1.0, k=MD17_K, sampling_kwargs=euler,
                                generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
    counts = read_counts()
    # per drift evaluation: each of the 4 layers runs K3 on the spatial axis
    # (L=192 >= 128), K9 on the temporal axis (8 < T=30 < 128), K2 on both
    # axes' MLP branch and K7 twice, plus one K7 before the output layer;
    # stage 1 encodes the batch once (K1 with the bias on the masked cross-
    # attention, then fp32 K1 on the latent self-attention) and decodes the
    # K repeats in one call (fp32 K1 on the decoder's self-attention; its
    # output block has 32 queries and stays plain)
    e = MD17_DRIFT_EVALS
    want = {key: 0 for key in counts}
    want.update({"K1": MD17_DEPTH * e + 3, "K1 bias": 1, "K1 fp32": 3, "K2": 2 * MD17_DEPTH * e,
                 "K7": (2 * MD17_DEPTH + 1) * e, "K9": MD17_DEPTH * e})
    want = with_sm90(want)
    bf16_k1 = counts["K1"] - counts["K1 fp32"]  # the bf16 launches: K3 on the spatial axis
    print(f"md17: evaluate_md17 K={MD17_K} Euler-{NUM_STEPS} B={MD17_BATCH}: {metrics}; launches "
          f"{counts}, of which K1 bf16 {bf16_k1} (expected {want}, K1 bf16 {MD17_DEPTH * e})")
    check(counts == want and bf16_k1 == MD17_DEPTH * e,
          f"md17 protocol launches {counts} != {want}")
    check(all(math.isfinite(x) for x in metrics.values()), "non-finite MD17 ADE/FDE")

    # kernel path vs plain path on the same weights and noise
    zeroed = zero_target_frames(batch, cond_end)
    true_pos, mask = batch["pos"][:, cond_end:], batch["attention_mask"][:, cond_end:]
    noise = torch.randn((MD17_K, MD17_BATCH, MD17_T, cfg1.num_latents, cfg1.dim_latent), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    sample_k = ss.make_k_sample_fn(MD17_K, sampling_kwargs=euler)

    def protocol_batch():
        preds = sample_k(zeroed, noise=noise)
        return preds, mean_over_k_ade_fde(preds["pos"][:, :, cond_end:], true_pos, mask)

    with torch.no_grad():
        got, (ade, fde) = protocol_batch()
        set_all("plain")
        want_out, (ade_p, fde_p) = protocol_batch()
        set_all("auto")
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got["pos"], want_out["pos"])
        print(f"md17: decoded pos {list(got['pos'].shape)}, kernel vs plain path: max_abs_err "
              f"{abs_err:.3e} rel {rel_err:.3e} (tol {MD17_POS_REL_TOL}); ADE/FDE kernel "
              f"{ade.mean().item():.5f}/{fde.mean().item():.5f} plain "
              f"{ade_p.mean().item():.5f}/{fde_p.mean().item():.5f}")
        check(bool(torch.isfinite(got["pos"]).all()), "non-finite decoded positions")
        check(bool(torch.isfinite(ade).all() & torch.isfinite(fde).all()), "non-finite ADE/FDE")
        check(rel_err <= MD17_POS_REL_TOL, f"md17 kernel vs plain pos rel err {rel_err}")
        del got, want_out

        # timing: plain, kernel, kernel, plain (each path ran once above)
        torch.cuda.reset_peak_memory_stats()
        times = {"auto": [], "plain": []}
        for backend in ("plain", "auto", "auto", "plain"):
            set_all(backend)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            protocol_batch()
            end.record()
            torch.cuda.synchronize()
            times[backend].append(start.elapsed_time(end))
        set_all("auto")
        kern, plain = np.mean(times["auto"]), np.mean(times["plain"])
        n_traj = MD17_K * MD17_BATCH
        print(f"timing md17 protocol batch K={MD17_K} B={MD17_BATCH}: kernel path {kern:.3f} ms "
              f"({n_traj * MD17_DRIFT_EVALS / kern * 1e3:.2f} traj-ODE steps/s), plain path "
              f"{plain:.3f} ms ({n_traj * MD17_DRIFT_EVALS / plain * 1e3:.2f} traj-ODE steps/s); "
              f"runs kernel {[round(x, 3) for x in times['auto']]} plain "
              f"{[round(x, 3) for x in times['plain']]} ms; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {smi}")
        profile_run(protocol_batch, f"md17 protocol batch K={MD17_K} B={MD17_BATCH} kernel path")
    return counts


def f32_protocol_pair(ss, batch, seed: int):
    """The fp32 test protocol (evaluate_md17, K=5, Euler-10, k_chunk=1) on one
    batch through the kernels and through the plain path (TF32 off), both
    drawing their noise from a generator seeded with ``seed``: (kernel
    ADE/FDE, plain ADE/FDE)."""
    from lam_slide_tpu_torch.composites.testing import evaluate_md17
    from lam_slide_tpu_torch.nn.blocks import set_backend

    dev = next(ss.first_stage.parameters()).device
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = []
    for backend in ("auto", "plain"):
        for module in (ss.backbone, ss.first_stage):
            set_backend(module, backend)
        out.append(evaluate_md17(ss, {"md17": [batch]}, scale=1.0, k=MD17_K, k_chunk=1,
                                 generator=torch.Generator(device=dev).manual_seed(seed)))
    for module in (ss.backbone, ss.first_stage):
        set_backend(module, "auto")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return tuple(out)


def protocol_ulps(got: dict, want: dict) -> float:
    """The largest |got - want| over the metrics, in fp32 ulps of want's."""
    return max(abs(got[k] - want[k]) / float(np.spacing(np.float32(abs(want[k])))) for k in want)


def md17_loop_phase(dev, smi, reset_counts, read_counts):
    """Phase 14: MD17 through the port's own loop, by its CLI in-process in a
    temporary workspace: stage 1 at full width (fp32, B=256, one epoch with
    val), then stage 2 from the run registry (the bf16 DiT, B=64, one epoch,
    val over one batch, the K=5 val hook, the checkpoint) with the fp32
    --test pass over the test split, then --test-only from the checkpoint.
    Returns the launches of stage 2's training (val and hook included) and
    of its test pass."""
    import shutil
    import tempfile

    from lam_slide_tpu_torch.composites import testing
    from lam_slide_tpu_torch.experiments import registry
    from lam_slide_tpu_torch.train.cli import main as cli

    ws = tempfile.mkdtemp(prefix="md17_loop_")
    real = testing.evaluate_md17
    test_passes = []

    def spy(ss, loaders, **kw):
        """The CLI's test pass (k_chunk=1; the val hook passes none): its
        launches, protocol batches and time."""
        if kw.get("k_chunk") != 1:
            return real(ss, loaders, **kw)
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = real(ss, loaders, **kw)
        torch.cuda.synchronize()
        after = read_counts()
        test_passes.append(({key: after[key] - before[key] for key in after},
                            time.perf_counter() - t0, out))
        return out

    common = ["--workspace", ws, "--molecule", "aspirin", "--epochs", "1",
              "--exp-set", f"synthetic_frames={MD17_LOOP_FRAMES}"]
    testing.evaluate_md17 = spy
    try:
        t0 = time.perf_counter()
        rc1 = cli(["--experiment", "md17_first_stage", "--run-id", "s1",
                   "--set", "val_every_n_epochs=1", *common])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        rc2 = cli(["--experiment", "md17_second_stage", "--run-id", "s2",
                   "--first-stage-run", "s1", "--set", "val_every_n_epochs=1",
                   "--set", "limit_val_batches=1", "--test", *common])
        torch.cuda.synchronize()
        total = read_counts()
        t2 = time.perf_counter()
        rc3 = cli(["--workspace", ws, "--run-id", "s2", "--test-only", "--test-ckpt", "last"])
        t3 = time.perf_counter()
        print(f"md17_loop: stage 1 {t1 - t0:.2f} s, stage 2 with --test {t2 - t1:.2f} s, "
              f"--test-only {t3 - t2:.2f} s; return codes {rc1} {rc2} {rc3}")
        check((rc1, rc2, rc3) == (0, 0, 0), f"md17_loop: CLI return codes {rc1} {rc2} {rc3}")
        check(len(test_passes) == 2, f"md17_loop: {len(test_passes)} test passes, not 2")
        (test_counts, test_s, metrics), (_, retest_s, retest) = test_passes
        train_counts = {key: total[key] - test_counts[key] for key in total}

        with open(f"{ws}/runs.json") as f:
            runs = json.load(f)
        check(runs["s2"]["config"]["first_stage_run"] == "s1", "runs.json does not link s2 to s1")
        for run_id, splits in (("s1", ("train", "val/aspirin")),
                               ("s2", ("train", "val/aspirin", "hook/val_sample"))):
            with open(f"{ws}/{run_id}/metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            check([r["split"] for r in records] == list(splits),
                  f"{run_id} metrics.jsonl splits {[r['split'] for r in records]}")
            check(all(math.isfinite(v) for r in records for v in r.values()
                      if isinstance(v, float)), f"{run_id}: a non-finite metric")
            print(f"md17_loop {run_id} records: {records}")
        with open(f"{ws}/s2/test_metrics.json") as f:
            stored = json.load(f)
        keys = {"test/aspirin/ade", "test/aspirin/fde"}
        check(set(stored) == keys and all(math.isfinite(v) for v in stored.values()),
              f"test_metrics.json {stored}")
        check(retest == metrics == stored, f"--test-only {retest} != --test {metrics}")

        # the test pass ran the fp32 kernels only; training the bf16 ones and K4
        bf16 = {k: test_counts[k] - test_counts[f"{k} fp32"] for k in ("K1", "K2", "K7", "K9")}
        print(f"md17_loop: --test {metrics} in {test_s:.2f} s (--test-only {retest_s:.2f} s); "
              f"test-pass launches {test_counts}; stage-2 training launches {train_counts}")
        check(all(test_counts[k] > 0 for k in ("K2 fp32", "K7 fp32", "K9 fp32", "K1 fp32")),
              "md17_loop: an fp32 kernel did not launch in the test pass")
        check(test_counts["K2 fp32 tiled"] == test_counts["K2 fp32"]
              and test_counts["K2 fp32 dot"] == 0,
              f"md17_loop: K2-fp32 left its outer-product kernel in the test pass: {test_counts}")
        check(test_counts["K1 fp32 narrow"] == test_counts["K1 fp32"],
              f"md17_loop: K1-fp32 at dh 16 left its narrow kernel in the test pass: "
              f"{test_counts}")
        check(all(v == 0 for v in bf16.values()) and test_counts["K8"] == 0,
              f"md17_loop: a bf16 DiT kernel launched in the test pass: {bf16}")
        check(all(train_counts[k] - train_counts[f"{k} fp32"] > 0 for k in ("K2", "K7", "K9"))
              and train_counts["K9 bwd"] > 0 and train_counts["K4 kv"] > 0
              and train_counts["K1 sm90"] > 0,
              f"md17_loop: a bf16 kernel or K4 did not launch in training: {train_counts}")

        # the fp32 protocol on the first test batch, kernel path vs plain
        # path, then its time and profile, on the checkpoint's weights
        exp = registry.md17_second_stage(workspace=ws, first_stage_run="s1", molecule="aspirin",
                                         synthetic_frames=MD17_LOOP_FRAMES, device=dev)
        raw = registry.load_checkpoint_raw(f"{ws}/s2", "last")
        ss = exp.test_model
        ss.backbone.load_state_dict({**raw["params"], **raw["ema_params"]})
        batch = next(iter(exp.test_loaders["aspirin"]))
        kern, plain = f32_protocol_pair(ss, batch, SEED)
        ulps = protocol_ulps(kern, plain)
        print(f"md17_loop: fp32 protocol, first test batch (B={MD17_BATCH}), kernel path {kern} "
              f"plain path {plain}: {ulps:.1f} fp32 ulps (limit {MD17_F32_PROTOCOL_ULPS})")
        check(ulps <= MD17_F32_PROTOCOL_ULPS, f"md17_loop: fp32 protocol {ulps} ulps apart")

        def protocol_batch():
            return testing.evaluate_md17(ss, {"md17": [batch]}, scale=1.0, k=MD17_K, k_chunk=1)

        with torch.no_grad():
            protocol_batch()  # warm-up: the plain path ran last
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            protocol_batch()
            end.record()
            torch.cuda.synchronize()
            print(f"timing md17_loop fp32 test batch K={MD17_K} B={MD17_BATCH} k_chunk=1 kernel "
                  f"path {start.elapsed_time(end):.3f} ms | {smi}")
            profile_run(protocol_batch, f"md17_loop fp32 test batch K={MD17_K} B={MD17_BATCH}")
        del exp, ss, raw

        # the 2 x dh 128 split: stage 2 from the same stage 1 with
        # --exp-set num_heads=2 and the fp32 --test pass, whose DiT runs K5 in
        # fp32 on both axes (the fp32 transform, then K1's fp32 kernel)
        n_passes = len(test_passes)  # the checks above called evaluate_md17 too
        reset_counts()
        t0 = time.perf_counter()
        rc4 = cli(["--experiment", "md17_second_stage", "--run-id", "s2w",
                   "--first-stage-run", "s1", "--set", "val_every_n_epochs=1",
                   "--set", "limit_val_batches=1", "--exp-set", f"num_heads={MD17_WIDE_HEADS}",
                   "--test", *common])
        torch.cuda.synchronize()
        total = read_counts()
        wide_s = time.perf_counter() - t0
        check(rc4 == 0, f"md17_loop: the {MD17_WIDE_HEADS} x 128 run returned {rc4}")
        check(len(test_passes) == n_passes + 1,
              f"md17_loop: {len(test_passes) - n_passes} test passes of the "
              f"{MD17_WIDE_HEADS} x 128 run, not 1")
        wide_test, wide_test_s, wide_metrics = test_passes[n_passes]
        wide_train = {key: total[key] - wide_test[key] for key in total}
        with open(f"{ws}/s2w/test_metrics.json") as f:
            stored = json.load(f)
        check(stored == wide_metrics and set(stored) == keys
              and all(math.isfinite(v) for v in stored.values()),
              f"md17_loop {MD17_WIDE_HEADS} x 128: test_metrics.json {stored}")
        exp = registry.md17_second_stage(workspace=ws, first_stage_run="s1", molecule="aspirin",
                                         synthetic_frames=MD17_LOOP_FRAMES,
                                         num_heads=MD17_WIDE_HEADS, device=dev)
        check(exp.config.hidden_size // exp.config.num_heads == 128,
              f"md17_loop: the num_heads={MD17_WIDE_HEADS} run is not at dh 128")
        n_test = len(exp.test_loaders["aspirin"])
        # every layer's spatial (L = 192) and temporal (T = 30) attention is
        # K5 at dh 128: 2 x depth a drift evaluation, one repeat at a time
        want_k5 = 2 * MD17_DEPTH * MD17_DRIFT_EVALS * MD17_K * n_test
        print(f"md17_loop {MD17_WIDE_HEADS} x 128: stage 2 with --test {wide_s:.2f} s, --test "
              f"{wide_metrics} in {wide_test_s:.2f} s ({n_test} test batches); test-pass "
              f"launches {wide_test}; stage-2 training launches {wide_train}")
        check(wide_test["K5 fp32"] == wide_test["K5"] == wide_test["K5 transform"] == want_k5,
              f"md17_loop {MD17_WIDE_HEADS} x 128: K5-fp32 launches {wide_test['K5 fp32']}, "
              f"not {want_k5} ({want_k5 // n_test} a test batch)")
        check(wide_test["K5 fp32 wide"] == want_k5 and wide_test["K1 fp32 wide"] == 0
              and wide_test["K2 fp32 tiled"] == wide_test["K2 fp32"] > 0
              and wide_test["K2 fp32 dot"] == 0,
              f"md17_loop {MD17_WIDE_HEADS} x 128: the test pass did not run the register-tiled "
              f"K1-fp32 under every K5-fp32 call and the outer-product K2-fp32: {wide_test}")
        check(all(wide_test[k] == wide_test[f"{k} fp32"] > 0 for k in ("K1", "K2", "K7"))
              and wide_test["K9"] == wide_test["K8"] == wide_test["K5 sm90"] == 0,
              f"md17_loop {MD17_WIDE_HEADS} x 128: a bf16 kernel or K9 in the test pass")
        check(wide_train["K5"] - wide_train["K5 fp32"] > 0 and wide_train["K6"] > 0
              and wide_train["K9"] == wide_train["K9 bwd"] == 0,
              f"md17_loop {MD17_WIDE_HEADS} x 128: training did not take bf16 K5/K6 alone "
              f"(K9 at dh 128 is on no path): {wide_train}")
        raw = registry.load_checkpoint_raw(f"{ws}/s2w", "last")
        ss = exp.test_model
        ss.backbone.load_state_dict({**raw["params"], **raw["ema_params"]})
        batch = next(iter(exp.test_loaders["aspirin"]))
        kern, plain = f32_protocol_pair(ss, batch, SEED)
        ulps = protocol_ulps(kern, plain)
        print(f"md17_loop {MD17_WIDE_HEADS} x 128: fp32 protocol, first test batch, kernel path "
              f"{kern} plain path {plain}: {ulps:.1f} fp32 ulps (limit "
              f"{MD17_WIDE_F32_PROTOCOL_ULPS})")
        check(ulps <= MD17_WIDE_F32_PROTOCOL_ULPS,
              f"md17_loop {MD17_WIDE_HEADS} x 128: fp32 protocol {ulps} ulps apart")
        with torch.no_grad():
            protocol_batch()  # warm-up: the plain path ran last
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            protocol_batch()
            end.record()
            torch.cuda.synchronize()
            print(f"timing md17_loop {MD17_WIDE_HEADS} x 128 fp32 test batch K={MD17_K} "
                  f"B={MD17_BATCH} k_chunk=1 kernel path {start.elapsed_time(end):.3f} ms | {smi}")
            profile_run(protocol_batch, f"md17_loop {MD17_WIDE_HEADS} x 128 fp32 test batch "
                        f"K={MD17_K} B={MD17_BATCH}")
    finally:
        testing.evaluate_md17 = real
        shutil.rmtree(ws, ignore_errors=True)
    return train_counts, test_counts, wide_test


def min_k_batch_errors(ss, batch, cfg, seed: int):
    """The fp32 test protocol (``evaluate_min_k`` with the config's K,
    num_runs and post_process, k_chunk=1) on one batch through the kernels
    and through the plain path (TF32 off), both drawing their noise from a
    generator seeded with ``seed``, on the DiT's weights perturbed
    (``perturb_``, then restored): (kernel metrics, plain metrics, their
    largest relative difference, kernel s, plain s)."""
    from lam_slide_tpu_torch.composites.testing import evaluate_min_k
    from lam_slide_tpu_torch.nn.blocks import set_backend

    dev = next(ss.first_stage.parameters()).device
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    before = perturb_(ss.backbone, seed)
    out, secs = [], []
    for backend in ("auto", "plain"):
        for module in (ss.backbone, ss.first_stage):
            set_backend(module, backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out.append(evaluate_min_k(ss, {"batch": [batch]}, k=cfg.K, num_runs=cfg.num_runs,
                                      post_process=cfg.post_process, k_chunk=1,
                                      generator=torch.Generator(device=dev).manual_seed(seed)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    for module in (ss.backbone, ss.first_stage):
        set_backend(module, "auto")
    ss.backbone.load_state_dict(before)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    got, want = out
    check(all(math.isfinite(v) for v in got.values()), f"min-K protocol: non-finite {got}")
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    return got, want, rel, secs[0], secs[1]


def ped_nba_loop_phase(dev, smi, reset_counts, read_counts):
    """Phase 17: the pedestrian and NBA workloads through the port's CLI
    in-process in a temporary workspace, at the registries' full widths on
    synthetic data (PN_DATA): stage 1 (fp32; B=512 / 1024), then stage 2
    from the run registry (the bf16 class-conditional DiT, B=256 / 1024,
    one epoch, val over one batch a loader, the min-over-K val hook) with
    ``--test`` (the fp32 rebuild, K=20 / K=60 one repeat at a time, the first
    test batch of each loader; NBA with the k-means final-position
    clustering). Then the kernel path against the plain path on one test
    batch and the bf16 stage-2 step (``stage_checks``)."""
    import shutil
    import tempfile

    from lam_slide_tpu_torch.composites import testing
    from lam_slide_tpu_torch.data.loader import device_batch
    from lam_slide_tpu_torch.experiments import registry
    from lam_slide_tpu_torch.ops import fused_mlp as fm
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
    from lam_slide_tpu_torch.train.cli import main as cli

    ws = tempfile.mkdtemp(prefix="ped_nba_loop_")
    real = testing.evaluate_min_k
    passes = []

    def spy(ss, loaders, **kw):
        """The CLI's test pass (k_chunk=1) and the val hook's protocol: their
        launches, seconds and metrics."""
        kind = "test" if kw.get("k_chunk") == 1 else "hook"
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = real(ss, loaders, **kw)
        torch.cuda.synchronize()
        after = read_counts()
        passes.append((kind, {key: after[key] - before[key] for key in after},
                       time.perf_counter() - t0, out))
        return out

    testing.evaluate_min_k = spy
    try:
        for workload, (b, d, heads, l, k) in PN_SHAPES.items():
            knob, n1, n2 = PN_DATA[workload]
            common = ["--workspace", ws, "--epochs", "1", "--set", "val_every_n_epochs=1"]
            reset_counts()
            t0 = time.perf_counter()
            rc1 = cli(["--experiment", f"{workload}_first_stage", "--run-id", f"{workload}1",
                       "--exp-set", f"{knob}={n1}", *common])
            torch.cuda.synchronize()
            s1_counts = read_counts()
            t1 = time.perf_counter()
            reset_counts()
            n_passes = len(passes)
            rc2 = cli(["--experiment", f"{workload}_second_stage", "--run-id", f"{workload}2",
                       "--first-stage-run", f"{workload}1", "--exp-set", f"{knob}={n2}",
                       "--exp-set", "test_batches=1", "--set", "limit_val_batches=1", "--test",
                       *common])
            torch.cuda.synchronize()
            total = read_counts()
            t2 = time.perf_counter()
            print(f"ped_nba_loop {workload}: stage 1 {t1 - t0:.2f} s, stage 2 with --test "
                  f"{t2 - t1:.2f} s; return codes {rc1} {rc2}")
            check((rc1, rc2) == (0, 0), f"ped_nba_loop {workload}: CLI return codes {rc1} {rc2}")
            # stage 1 runs no kernel: its attention axes (at most 11 entities,
            # 8 latents) take the plain path, as in JAX (_pick_backend)
            check(not any(s1_counts.values()), f"ped_nba_loop {workload}: stage 1 launched "
                  f"{ {key: n for key, n in s1_counts.items() if n} }")
            run_passes = passes[n_passes:]
            kinds = [p[0] for p in run_passes]
            check(sorted(kinds) == ["hook", "test"], f"ped_nba_loop {workload}: passes {kinds}")
            (_, hook_counts, hook_s, hook_out), = [p for p in run_passes if p[0] == "hook"]
            (_, test_counts, test_s, metrics), = [p for p in run_passes if p[0] == "test"]
            train_counts = {key: total[key] - test_counts[key] - hook_counts[key]
                            for key in total}

            exp = registry.build_experiment(f"{workload}_second_stage", workspace=ws,
                                            first_stage_run=f"{workload}1", test_batches=1,
                                            device=dev, **{knob: n2})
            cfg = exp.config
            loaders = list(exp.val_loaders)
            splits = {f"{workload}1": ["train", *(f"val/{s}" for s in loaders)],
                      f"{workload}2": ["train", *(f"val/{s}" for s in loaders),
                                       "hook/val_sample"]}
            for run_id, want_splits in splits.items():
                with open(f"{ws}/{run_id}/metrics.jsonl") as f:
                    records = [json.loads(line) for line in f]
                check([r["split"] for r in records] == want_splits,
                      f"{run_id} metrics.jsonl splits {[r['split'] for r in records]}")
                check(all(math.isfinite(v) for r in records for v in r.values()
                          if isinstance(v, float)), f"{run_id}: a non-finite metric")
                print(f"ped_nba_loop {run_id} records: {records}")
            with open(f"{ws}/{workload}2/test_metrics.json") as f:
                stored = json.load(f)
            names = ("ade", "fde", "ade_post", "fde_post") if cfg.post_process else ("ade", "fde")
            keys = {f"test/{s}/{name}" for s in loaders for name in names}
            check(stored == metrics and set(stored) == keys
                  and all(math.isfinite(v) for v in stored.values()),
                  f"ped_nba_loop {workload}: test_metrics.json {stored}, keys {sorted(keys)}")
            check(cfg.K == k and cfg.post_process == (workload == "nba"),
                  f"ped_nba_loop {workload}: K {cfg.K}, post_process {cfg.post_process}")

            # exact launches: per DiT forward, per layer K8 (spatial, L
            # latents), K9 (temporal, T frames), K2 (its MLP branch) and two
            # K7, and one K7 for the output AdaLN; a train step adds K9's
            # backward per layer (no checkpointing); the Euler-10 solve makes
            # DRIFT_EVALS forwards; the val hook solves its K=20 repeats of
            # one batch a loader as one batch, the test pass K repeats one at
            # a time over test_batches=1 a loader
            raw = registry.load_checkpoint_raw(f"{ws}/{workload}2", "last")
            steps, n_loaders = int(raw["step"]), len(loaders)
            n_test = sum(len(loader) for loader in exp.test_loaders.values())
            per_fwd = {"K8": PN_DEPTH, "K9": PN_DEPTH, "K2": PN_DEPTH, "K7": 2 * PN_DEPTH + 1}
            zero = {key: 0 for key in total}
            want_train = dict(zero, **{key: n * (steps + n_loaders) for key, n in per_fwd.items()},
                              **{"K9 bwd": PN_DEPTH * steps})
            want_hook = dict(zero, **{key: n * n_loaders * DRIFT_EVALS
                                      for key, n in per_fwd.items()})
            # the fp32 test pass: K8 and K2 on their outer-product kernels
            check(fsb.f32_plan(b * PN_T, l, d, 2 * d, heads).route == "tiled"
                  and fm.tiled_plan(d, 2 * d, d, b * PN_T * l) is not None,
                  f"ped_nba_loop {workload}: an fp32 plan without the outer-product route")
            want_test = dict(zero, **{key: n * n_test * k * DRIFT_EVALS
                                      for key, n in per_fwd.items()})
            want_test.update({f"{key} fp32": want_test[key] for key in per_fwd})
            want_test.update({"K8 fp32 tiled": want_test["K8"], "K2 fp32 tiled": want_test["K2"]})
            print(f"ped_nba_loop {workload}: stage 2 {steps} steps, {n_loaders} val loaders, "
                  f"{n_test} test batches; training launches {train_counts}; val hook launches "
                  f"{hook_counts} ({hook_s:.2f} s, {hook_out}); test-pass launches {test_counts}")
            for what, got, want in (("training", train_counts, want_train),
                                    ("val hook", hook_counts, want_hook),
                                    ("test pass", test_counts, want_test)):
                check(got == want, f"ped_nba_loop {workload} {what} launches "
                      f"{ {key: n for key, n in got.items() if n} } != "
                      f"{ {key: n for key, n in want.items() if n} }")
            print(f"timing ped_nba_loop {workload} fp32 test pass: {n_test} test batches of "
                  f"B={b}, K={k}, k_chunk=1: {test_s:.3f} s ({test_s / n_test * 1e3:.3f} ms a "
                  f"test batch) | {smi}")
            print(f"ped_nba_loop {workload}: --test {metrics}")

            # one of the test pass's K repeats on a test batch, profiled (the
            # pass's trace would hold K times its launches)
            ss = exp.test_model
            ss.backbone.load_state_dict({**raw["params"], **raw["ema_params"]})
            full = device_batch(next(iter(exp.test_loaders[loaders[0]])), dev)
            one_repeat = ss.make_k_sample_fn(k=1, sampling_kwargs={
                "sampling_method": "euler", "num_steps": NUM_STEPS})
            with torch.no_grad():
                profile_run(lambda: one_repeat(full, generator=torch.Generator(
                    device=dev).manual_seed(SEED)), f"ped_nba_loop {workload} fp32 test batch "
                    f"B={b}, one of its K={k} repeats (encode, Euler-{NUM_STEPS}, decode)")

            # the kernel path against the plain path on one test batch
            rows = PN_CMP_ROWS[workload]
            batch = {key: val[:rows] for key, val in full.items()}
            got, want, rel, kern_s, plain_s = min_k_batch_errors(ss, batch, cfg, SEED)
            print(f"ped_nba_loop {workload}: fp32 protocol on the first {rows} windows of the "
                  f"first test batch (K={cfg.K}), kernel path {got} plain path {want}: largest "
                  f"rel difference {rel:.3e} (tol {PN_METRIC_REL_TOL})")
            print(f"timing ped_nba_loop {workload} fp32 test batch B={rows} K={cfg.K} "
                  f"k_chunk=1: kernel path {kern_s * 1e3:.3f} ms, plain path "
                  f"{plain_s * 1e3:.3f} ms | {smi}")
            check(rel <= PN_METRIC_REL_TOL, f"ped_nba_loop {workload}: the kernel path's "
                  f"metrics {rel} apart from the plain path's")
            del ss

            # the bf16 stage-2 step at full width on perturbed weights
            perturb_(exp.model, SEED)
            ss2 = exp.second_stage
            batch2 = device_batch(next(iter(exp.train_loader)), dev)
            check(batch2["pos"].shape[:2] == (b, PN_T),
                  f"{workload} stage-2 batch {tuple(batch2['pos'].shape)}")
            grad_batch = {key: val[:GRAD_BATCH] for key, val in batch2.items()}
            want_step = dict(zero, **per_fwd, **{"K9 bwd": PN_DEPTH})
            stage_checks(f"{workload} stage 2", exp, batch2, grad_batch, want_step,
                         [ss2.backbone, ss2.first_stage], dev, smi, reset_counts, read_counts,
                         PN_S2_GRAD_REL_TOL, ("si_loss",), phase="ped_nba_loop",
                         profile=workload == "nba")
            del exp, ss2, batch2, grad_batch, raw
            torch.cuda.empty_cache()
    finally:
        testing.evaluate_min_k = real
        shutil.rmtree(ws, ignore_errors=True)



def _steady_step_ms(step, state, batch, reps: int = 3):
    """Median CUDA-synchronized wall time of ``reps`` train steps after one
    warm-up step; returns (ms, the state)."""
    state, _ = step(state, batch, SEED)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, _ = step(state, batch, SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), state


def perturb_(model, seed: int):
    """Add seeded N(0, PEP_PERTURB_STD^2) noise to every parameter of
    ``model`` in place; returns a copy of its state dict before. The
    reference init zeroes the DiT's modulations and output layer, so at the
    starting weights every block is the identity and no kernel moves the
    output: the kernel-vs-plain comparisons run on perturbed weights."""
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((PEP_PERTURB_STD * torch.randn(p.shape, generator=gen)).to(p.device, p.dtype))
    return before


def peptide_grad_errors(run2, grad_batch, seed: int):
    """Stage 2's metrics and DiT grads on ``grad_batch`` (the loss's t and x0
    from a generator seeded with ``seed``), kernel path against plain path,
    on the run's weights perturbed (``perturb_``, then restored): (worst
    metric rel err, global grad norm rel err, (worst per-tensor
    ||g - g_ref|| / ||g_ref||, its name), every loss and grad finite)."""
    from lam_slide_tpu_torch.nn.blocks import set_backend

    ss, model = run2.second_stage, run2.model
    dev = next(model.parameters()).device
    before = perturb_(model, seed)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        total, metrics = run2.loss_fn(model, grad_batch,
                                      torch.Generator(device=dev).manual_seed(seed), True)
        total.backward()
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return {k: v.item() for k, v in metrics.items()}, grads

    got_m, got_g = loss_and_grads()
    for module in (ss.backbone, ss.first_stage):
        set_backend(module, "plain")
    ref_m, ref_g = loss_and_grads()
    for module in (ss.backbone, ss.first_stage):
        set_backend(module, "auto")
    model.load_state_dict(before)
    loss_err = max(abs(got_m[k] - ref_m[k]) / abs(ref_m[k]) for k in ref_m)
    norm_err = abs(_global_norm(got_g) - _global_norm(ref_g)) / _global_norm(ref_g)
    worst = max(((got_g[n] - r).norm().item() / r.norm().item(), n) for n, r in ref_g.items())
    finite = (all(math.isfinite(v) for v in got_m.values())
              and all(bool(torch.isfinite(g).all()) for g in got_g.values()))
    return loss_err, norm_err, worst, finite


def peptide_window_batch(ss, trajs):
    """The eval's T-frame batch (``RolloutSampler.create_batch``) on the
    first frames of the first PEP_EVAL_IDS trajectories."""
    from lam_slide_tpu_torch.analysis.rollout import RolloutSampler

    sampler = RolloutSampler(ss)
    trajs = trajs[:len(PEP_EVAL_IDS)]

    def stack(key, dtype):
        return torch.as_tensor(np.stack([t[key][0] for t in trajs]),
                               device=sampler.device).to(dtype)

    return sampler.create_batch(stack("atom14_pos", torch.float32), stack("aatype", torch.long),
                                stack("atom14_mask", torch.float32))


def peptide_window_errors(ss, batch, seed: int):
    """One fp32 Euler-10 window of ``ss`` on ``batch`` at the noise of
    ``seed``, kernel path against plain path (TF32 off), on the DiT's weights
    perturbed (``perturb_``, then restored): (max abs err, rel err to max
    |pos|, max |pos|) of the decoded atom14."""
    from lam_slide_tpu_torch.nn.blocks import set_backend

    dev = next(ss.backbone.parameters()).device
    b = batch["aatype"].shape[0]
    noise = torch.randn((b, T, L, DIN), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    window = ss.make_sample_fn(sampling_kwargs={"sampling_method": "euler",
                                                "num_steps": NUM_STEPS})
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    before = perturb_(ss.backbone, seed)
    got = window(batch, noise=noise)["atom14_pos"]
    for module in (ss.backbone, ss.first_stage):
        set_backend(module, "plain")
    want = window(batch, noise=noise)["atom14_pos"]
    for module in (ss.backbone, ss.first_stage):
        set_backend(module, "auto")
    ss.backbone.load_state_dict(before)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    check(bool(torch.isfinite(got).all()), "peptide fp32 window: non-finite positions")
    abs_err, rel = errors(got, want)
    return abs_err, rel, want.abs().max().item()


def peptide_loop_phase(dev, smi, reset_counts, read_counts):
    """Phase 15: the 4AA workload through the port's entry points, in-process
    in a temporary workspace at full width on synthetic peptides (the cuts
    beside PEP_S1_REPEATS): ``train.cli`` stage 1 (fp32, B=512, three steps,
    val), then stage 2 read from the run registry (the bf16 DiT of depth 7,
    hidden 384, 16 x 24, T = 1000, B=16, the aux geometry losses, three
    steps, val over one batch) with ``--test`` (the pointer to eval_cli),
    then ``analysis.eval_cli`` on that run (the fp32 DiT, dopri5, two test
    peptides in one batch x two rollouts, the JSD analysis). Checks: return
    codes, finite metric streams and JSD summary, the PDB files, the
    launches (eval: the fp32 K8, K3, K2 and K7 and no bf16 DiT kernel;
    training: the bf16 ones and K4); stage 2's loss and grads before any
    step and one fp32 Euler-10 window, kernel path against plain (TF32 off),
    on perturbed weights (``perturb_``). Prints the step times, each eval window's dopri5
    steps and solve time, the eval's wall time, and a profile of the fp32
    window. Returns the eval's launches at both splits and, for phase 19,
    the 16 x 24 stage-2 run (registry run and best checkpoint)."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from lam_slide_tpu_torch.analysis import eval_cli
    from lam_slide_tpu_torch.data.loader import device_batch
    from lam_slide_tpu_torch.experiments import registry
    from lam_slide_tpu_torch.train import create_train_state, make_train_step
    from lam_slide_tpu_torch.train.cli import main as cli
    from lam_slide_tpu_torch.transport import integrators
    from lam_slide_tpu_torch.utils.trees import tree_to_f32

    ws = tempfile.mkdtemp(prefix="peptide_loop_")
    saved_env = os.environ.get("LAM_SLIDE_NO_DATA_CACHE")
    os.environ["LAM_SLIDE_NO_DATA_CACHE"] = "1"  # time the precompute; leave no files
    real_dopri5 = integrators.ode_dopri5
    windows = []

    def dopri5_spy(*args, return_stats=False, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, stats = real_dopri5(*args, return_stats=True, **kw)
        torch.cuda.synchronize()
        windows.append((stats, time.perf_counter() - t0))
        return (x, stats) if return_stats else x

    common = ["--workspace", ws, "--epochs", "1", "--set", "val_every_n_epochs=1"]
    s2_sets = ["--exp-set", f"synthetic_frames={PEP_S2_FRAMES}",
               "--exp-set", f"repeats={PEP_S2_REPEATS}"]
    try:
        # 1. stage 1, then stage 2 from the run registry with --test
        t0 = time.perf_counter()
        rc1 = cli(["--experiment", "peptide_first_stage", "--run-id", "p1",
                   "--exp-set", f"repeats={PEP_S1_REPEATS}", *common])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc2 = cli(["--experiment", "peptide_second_stage", "--run-id", "p2",
                       "--first-stage-run", "p1", "--set", "limit_val_batches=1", "--test",
                       *s2_sets, *common])
        torch.cuda.synchronize()
        train_counts = read_counts()
        t2 = time.perf_counter()
        print(out.getvalue(), end="")
        print(f"peptide_loop: stage 1 {t1 - t0:.2f} s, stage 2 with --test {t2 - t1:.2f} s "
              f"(datasets, steps, val, checkpoints); return codes {rc1} {rc2}")
        check((rc1, rc2) == (0, 0), f"peptide_loop: CLI return codes {rc1} {rc2}")
        check("analysis.eval_cli --run p2" in out.getvalue()
              and not os.path.exists(f"{ws}/p2/test_metrics.json"),
              "peptide_loop: --test did not point to eval_cli, or wrote metrics")
        with open(f"{ws}/runs.json") as f:
            runs = json.load(f)
        check(runs["p2"]["config"]["first_stage_run"] == "p1", "runs.json does not link p2 to p1")
        for run_id in ("p1", "p2"):
            with open(f"{ws}/{run_id}/metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            check([r["split"] for r in records] == ["train", "val/val"],
                  f"{run_id} metrics.jsonl splits {[r['split'] for r in records]}")
            check(all(math.isfinite(v) for r in records for v in r.values()
                      if isinstance(v, float)), f"{run_id}: a non-finite metric")
            print(f"peptide_loop {run_id} records: {records}")
        bf16 = {k: train_counts[k] - train_counts.get(f"{k} fp32", 0)
                for k in ("K1", "K2", "K7", "K8")}
        print(f"peptide_loop: stage-2 training launches {train_counts}")
        check(all(v > 0 for v in bf16.values()) and train_counts["K4 sm90"] > 0
              and train_counts["K8 fp32"] == 0,
              f"peptide_loop: a bf16 kernel or K4 did not launch in training: {train_counts}")

        # 2. steady step times of both stages on the registry's runs (the
        # loop's epoch times above include the first steps' set-up)
        run1 = registry.peptide_first_stage(repeats=PEP_S1_REPEATS, device=dev)
        batch1 = device_batch(next(iter(run1.train_loader)), dev)
        step1 = make_train_step(run1.loss_fn, run1.tx, ema_decay=run1.trainer_cfg.ema_decay)
        ms1, _ = _steady_step_ms(step1, create_train_state(run1.model, run1.tx), batch1)
        run2 = registry.peptide_second_stage(workspace=ws, first_stage_run="p1",
                                             synthetic_frames=PEP_S2_FRAMES,
                                             repeats=PEP_S2_REPEATS, device=dev)
        batch2 = device_batch(next(iter(run2.train_loader)), dev)
        check(tuple(batch2["atom14_pos"].shape) == (TRAIN_BATCH, T, 4, 14, 3),
              f"peptide stage-2 batch {tuple(batch2['atom14_pos'].shape)}")

        # stage 2's loss and grads before any step, kernel path vs plain path,
        # on the same draws (t, x0) at B=2, on perturbed starting weights
        grad_batch = {k: v[:GRAD_BATCH] for k, v in batch2.items()}
        loss_err, norm_err, (worst, where), finite = peptide_grad_errors(run2, grad_batch, SEED)
        print(f"peptide_loop stage 2 B={GRAD_BATCH}, kernel path vs plain (bf16 DiT, fp32 "
              f"stage 1, weights + N(0, {PEP_PERTURB_STD}^2)): worst metric rel err "
              f"{loss_err:.3e} (tol {PEP_S2_LOSS_REL_TOL}); grads: global norm rel err "
              f"{norm_err:.3e} (tol {PEP_S2_GRAD_REL_TOL[0]}), worst tensor rel err {worst:.3e} "
              f"at {where} (tol {PEP_S2_GRAD_REL_TOL[1]})")
        check(finite, "peptide_loop stage 2: a non-finite loss or grad")
        check(loss_err <= PEP_S2_LOSS_REL_TOL, f"peptide stage-2 loss vs plain {loss_err}")
        check(norm_err <= PEP_S2_GRAD_REL_TOL[0], f"peptide stage-2 grad norm vs plain {norm_err}")
        check(worst <= PEP_S2_GRAD_REL_TOL[1], f"peptide stage-2 grad of {where} vs plain {worst}")
        step2 = make_train_step(run2.loss_fn, run2.tx, ema_decay=run2.trainer_cfg.ema_decay)
        ms2, _ = _steady_step_ms(step2, create_train_state(run2.model, run2.tx), batch2)
        print(f"timing peptide_loop: stage 1 step B={batch1['aatype'].shape[0]} {ms1:.3f} ms, "
              f"stage 2 step B={TRAIN_BATCH} {ms2:.3f} ms (kernel path, median of 3) | {smi}")
        del run1, batch1, step1, run2, step2, grad_batch
        torch.cuda.empty_cache()

        # 3. eval_cli on the stage-2 run: the fp32 DiT, dopri5
        integrators.ode_dopri5 = dopri5_spy
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc3 = eval_cli.main(["--run", "p2", "--workspace", ws, "--batch-peptides",
                             "--num-rollouts", str(PEP_ROLLOUTS), "--pdb-ids", *PEP_EVAL_IDS])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_counts = read_counts()
        integrators.ode_dopri5 = real_dopri5
        check(rc3 == 0, f"peptide_loop: eval_cli returned {rc3}")
        with open(f"{ws}/p2/eval/metrics.json") as f:
            metrics = json.load(f)
        summary = metrics["summary"]
        check(set(summary) == {"BB", "SC", "ALL", "TICA-0", "TICA-0,1", "MSMS"}
              and all(math.isfinite(v) for v in summary.values())
              and all(math.isfinite(v) for d in metrics["per_peptide"].values()
                      for v in d.values()), f"peptide_loop: eval summary {summary}")
        pdbs = sorted(p for p in os.listdir(f"{ws}/p2/eval") if p.endswith(".pdb"))
        check(pdbs == [f"{n}.pdb" for n in PEP_EVAL_IDS], f"peptide_loop: PDB files {pdbs}")
        check(len(windows) == PEP_ROLLOUTS, f"peptide_loop: {len(windows)} dopri5 solves")
        for i, ((n_iters, n_acc), solve_s) in enumerate(windows):
            check(n_iters < DOPRI5_MAX_STEPS, f"eval window {i}: dopri5 hit max_steps")
            print(f"timing peptide_loop eval window {i} (fp32, B={len(PEP_EVAL_IDS)}, T={T}): "
                  f"dopri5 {n_iters} steps, {n_acc} accepted, NFE {1 + 6 * n_iters}, solve "
                  f"{solve_s:.3f} s | {smi}")
        fp32_kernels = ("K8 fp32", "K1 fp32", "K2 fp32", "K7 fp32")
        bf16 = {k: eval_counts[k] - eval_counts[f"{k} fp32"] for k in ("K1", "K2", "K7", "K8")}
        print(f"peptide_loop: eval_cli {summary} in {eval_s:.2f} s wall (datasets, "
              f"{PEP_ROLLOUTS} windows, PDBs, the JSD/TICA/MSM analysis); launches {eval_counts}"
              f" | {smi}")
        check(all(eval_counts[k] > 0 for k in fp32_kernels),
              "peptide_loop: an fp32 kernel did not launch in the eval")
        check(eval_counts["K2 fp32 tiled"] == eval_counts["K2 fp32"]
              and eval_counts["K2 fp32 dot"] == 0,
              f"peptide_loop: K2-fp32 left its outer-product kernel in the eval: {eval_counts}")
        check(eval_counts["K8 fp32 tiled"] == eval_counts["K8 fp32"]
              and eval_counts["K8 fp32 dot"] == 0
              and eval_counts["K1 fp32 narrow"] == eval_counts["K1 fp32"],
              f"peptide_loop: K8-fp32 left its outer-product kernel or K3-fp32 its narrow one "
              f"in the eval: {eval_counts}")
        check(all(v == 0 for v in bf16.values()) and eval_counts["K5"] == 0
              and eval_counts["K9"] == 0, f"peptide_loop: a bf16 DiT kernel launched: {bf16}")

        # 4. one fp32 Euler-10 window at fixed noise, kernel path vs plain path
        # (TF32 off) on the trained weights perturbed, then its time and profile
        exp = registry.peptide_second_stage(workspace=ws, first_stage_run="p1",
                                            synthetic_peptides=2, synthetic_frames=PEP_S2_FRAMES,
                                            device=dev)
        raw = registry.load_checkpoint_raw(f"{ws}/p2", "best")
        pep_state = (exp, raw)  # phase 19's sampling hook runs on this run
        ss = exp.test_model
        ss.backbone.load_state_dict(tree_to_f32({**raw["params"], **raw["ema_params"]}))
        ss.backbone.eval()
        batch = peptide_window_batch(ss, exp.test_loaders["test"].dataset.trajectories)
        reset_counts()
        abs_err, rel, max_pos = peptide_window_errors(ss, batch, SEED)
        window_counts = read_counts()
        print(f"peptide_loop: fp32 Euler-{NUM_STEPS} window B={len(PEP_EVAL_IDS)}, kernel path vs "
              f"plain (TF32 off, weights + N(0, {PEP_PERTURB_STD}^2)): decoded atom14 max_abs_err "
              f"{abs_err:.3e} rel {rel:.3e} (tol {PEP_WINDOW_REL_TOL}), max|pos| {max_pos:.3f}; "
              f"launches {window_counts}")
        check(rel <= PEP_WINDOW_REL_TOL, f"peptide_loop: fp32 window vs plain rel err {rel}")
        noise = torch.randn((len(PEP_EVAL_IDS), T, L, DIN), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED))
        window = ss.make_sample_fn(sampling_kwargs={"sampling_method": "euler",
                                                    "num_steps": NUM_STEPS})
        with torch.no_grad():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            window(batch, noise=noise)
            end.record()
            torch.cuda.synchronize()
            print(f"timing peptide_loop fp32 Euler-{NUM_STEPS} window B={len(PEP_EVAL_IDS)}: "
                  f"{start.elapsed_time(end):.3f} ms kernel path | {smi}")
            profile_run(lambda: window(batch, noise=noise),
                        f"peptide_loop fp32 Euler-{NUM_STEPS} window B={len(PEP_EVAL_IDS)}")
        del exp, raw, ss, batch, window

        # 5. the 3 x dh 128 split: stage 2 from the same stage 1 with
        # --exp-set num_heads=3 (three steps), then eval_cli on it: the fp32
        # DiT's temporal attention is K5 in fp32 (the fp32 transform, then
        # K1's fp32 kernel), its spatial blocks K8-fp32 at 3 x 128
        heads = f"{WIDE_HEADS} x {HIDDEN // WIDE_HEADS}"
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc4 = cli(["--experiment", "peptide_second_stage", "--run-id", "p2w",
                       "--first-stage-run", "p1", "--set", "limit_val_batches=1",
                       "--exp-set", f"num_heads={WIDE_HEADS}", *s2_sets, *common])
        torch.cuda.synchronize()
        wide_train = read_counts()
        t1 = time.perf_counter()
        check(rc4 == 0, f"peptide_loop {heads}: stage 2 returned {rc4}")
        check(wide_train["K5"] - wide_train["K5 fp32"] > 0 and wide_train["K6"] > 0
              and wide_train["K8"] > 0 and wide_train["K8 fp32"] == 0 and wide_train["K1"] == 0,
              f"peptide_loop {heads}: training did not take bf16 K5, K6 and K8: {wide_train}")
        windows.clear()
        integrators.ode_dopri5 = dopri5_spy
        reset_counts()
        rc5 = eval_cli.main(["--run", "p2w", "--workspace", ws, "--batch-peptides",
                             "--num-rollouts", str(PEP_ROLLOUTS), "--pdb-ids", *PEP_EVAL_IDS])
        torch.cuda.synchronize()
        wide_eval_s = time.perf_counter() - t1
        wide_eval = read_counts()
        integrators.ode_dopri5 = real_dopri5
        check(rc5 == 0, f"peptide_loop {heads}: eval_cli returned {rc5}")
        with open(f"{ws}/p2w/eval/metrics.json") as f:
            metrics = json.load(f)
        summary = metrics["summary"]
        check(set(summary) == {"BB", "SC", "ALL", "TICA-0", "TICA-0,1", "MSMS"}
              and all(math.isfinite(v) for v in summary.values()),
              f"peptide_loop {heads}: eval summary {summary}")
        check(len(windows) == PEP_ROLLOUTS, f"peptide_loop {heads}: {len(windows)} dopri5 solves")
        nfe = 0
        for i, ((n_iters, n_acc), solve_s) in enumerate(windows):
            check(n_iters < DOPRI5_MAX_STEPS, f"eval window {i} at {heads}: dopri5 hit max_steps")
            nfe += 1 + 6 * n_iters
            print(f"timing peptide_loop {heads} eval window {i} (fp32, B={len(PEP_EVAL_IDS)}, "
                  f"T={T}): dopri5 {n_iters} steps, {n_acc} accepted, NFE {1 + 6 * n_iters}, "
                  f"solve {solve_s:.3f} s | {smi}")
        print(f"peptide_loop {heads}: stage 2 (three steps, val) {t1 - t0:.2f} s, training "
              f"launches {wide_train}; eval_cli {summary} in {wide_eval_s:.2f} s wall; launches "
              f"{wide_eval} | {smi}")
        want_k5 = DEPTH * nfe  # one temporal attention a layer a drift evaluation
        check(wide_eval["K5 fp32"] == wide_eval["K5"] == wide_eval["K5 transform"] == want_k5
              and wide_eval["K8 fp32"] == wide_eval["K8"] == wide_eval["K8 fp32 tiled"]
              == want_k5,
              f"peptide_loop {heads}: K5-fp32 / K8-fp32 launches {wide_eval['K5 fp32']} / "
              f"{wide_eval['K8 fp32']}, not {DEPTH} x NFE = {want_k5}")
        check(all(wide_eval[k] == wide_eval[f"{k} fp32"] for k in ("K2", "K7"))
              and wide_eval["K1"] == wide_eval["K5 sm90"] == wide_eval["K9"] == 0,
              f"peptide_loop {heads}: a bf16 DiT kernel or K3 launched in the eval: {wide_eval}")
        check(wide_eval["K5 fp32 wide"] == want_k5
              and wide_eval["K2 fp32 tiled"] == wide_eval["K2 fp32"] > 0
              and wide_eval["K2 fp32 dot"] == 0,
              f"peptide_loop {heads}: the eval did not run the register-tiled K1-fp32 under "
              f"every K5-fp32 call and the outer-product K2-fp32: {wide_eval}")

        # one fp32 Euler-10 window at 3 x 128, kernel path vs plain path
        # (TF32 off) on the trained weights perturbed, then its time and profile
        exp = registry.peptide_second_stage(workspace=ws, first_stage_run="p1",
                                            synthetic_peptides=2, synthetic_frames=PEP_S2_FRAMES,
                                            num_heads=WIDE_HEADS, device=dev)
        raw = registry.load_checkpoint_raw(f"{ws}/p2w", "best")
        ss = exp.test_model
        ss.backbone.load_state_dict(tree_to_f32({**raw["params"], **raw["ema_params"]}))
        ss.backbone.eval()
        batch = peptide_window_batch(ss, exp.test_loaders["test"].dataset.trajectories)
        reset_counts()
        abs_err, rel, max_pos = peptide_window_errors(ss, batch, SEED)
        print(f"peptide_loop {heads}: fp32 Euler-{NUM_STEPS} window B={len(PEP_EVAL_IDS)}, kernel "
              f"path vs plain (TF32 off, weights + N(0, {PEP_PERTURB_STD}^2)): decoded atom14 "
              f"max_abs_err {abs_err:.3e} rel {rel:.3e} (tol {PEP_WIDE_WINDOW_REL_TOL}), max|pos| "
              f"{max_pos:.3f}; launches {read_counts()}")
        check(rel <= PEP_WIDE_WINDOW_REL_TOL, f"peptide_loop {heads}: fp32 window rel err {rel}")
        window = ss.make_sample_fn(sampling_kwargs={"sampling_method": "euler",
                                                    "num_steps": NUM_STEPS})
        with torch.no_grad():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            window(batch, noise=noise)
            end.record()
            torch.cuda.synchronize()
            print(f"timing peptide_loop {heads} fp32 Euler-{NUM_STEPS} window "
                  f"B={len(PEP_EVAL_IDS)}: {start.elapsed_time(end):.3f} ms kernel path | {smi}")
            profile_run(lambda: window(batch, noise=noise),
                        f"peptide_loop {heads} fp32 Euler-{NUM_STEPS} window B={len(PEP_EVAL_IDS)}")
    finally:
        integrators.ode_dopri5 = real_dopri5
        if saved_env is None:
            os.environ.pop("LAM_SLIDE_NO_DATA_CACHE", None)
        else:
            os.environ["LAM_SLIDE_NO_DATA_CACHE"] = saved_env
        shutil.rmtree(ws, ignore_errors=True)
    return eval_counts, wide_eval, pep_state


def stage_checks(label, run, batch, grad_batch, want, plain_modules, dev, smi,
                 reset_counts, read_counts, grad_tol, falling, phase="md17_train",
                 steps=TRAIN_STEPS, timed=TIMED_STEPS, profile=True):
    """One training stage's train-step checks (phases 10 and 16) through the
    run's loss, optimizer and ``make_train_step``: every grad finite and
    non-zero and the kernel path's grads on ``grad_batch`` against the plain
    path (``plain_modules`` set to "plain") on the same draws, at the
    stage's starting weights; the launches of one step against ``want``;
    ``steps`` steps on ``batch`` with one fixed draw (dropout, t and x0), in
    which every metric stays finite and the ``falling`` ones fall; step
    times of both paths (median of ``timed``, in turns) with their peak
    memory; with ``profile``, one profiled step. ``phase`` prefixes the
    printed lines. Returns (the launches, the state)."""
    from lam_slide_tpu_torch.nn.blocks import set_backend
    from lam_slide_tpu_torch.train import create_train_state, make_train_step

    model, loss_fn = run.model, run.loss_fn
    state = create_train_state(model, run.tx)
    step = make_train_step(loss_fn, run.tx, ema_decay=run.trainer_cfg.ema_decay)

    def draws(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def set_all(backend):
        for m in plain_modules:
            set_backend(m, backend)

    def compare():
        # every parameter's grad finite and non-zero
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch, draws(SEED), True)[0].backward()
        bad = [n for n, p in model.named_parameters() if p.grad is None
               or not bool(torch.isfinite(p.grad).all()) or not p.grad.abs().max().item() > 0]
        n_params = len(list(model.parameters()))
        print(f"{phase} {label}: {n_params - len(bad)} of {n_params} parameters have a finite, "
              f"non-zero grad")
        check(not bad, f"{label}: parameters without a finite, non-zero grad: {bad}")

        # grads, kernel path vs plain path, on the same draws and weights
        def grads():
            model.zero_grad(set_to_none=True)
            loss_fn(model, grad_batch, draws(SEED + 1), True)[0].backward()
            out = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            return out

        got = grads()
        set_all("plain")
        ref = grads()
        set_all("auto")
        norm_err = abs(_global_norm(got) - _global_norm(ref)) / _global_norm(ref)
        worst, where = max(((got[n] - r).norm().item() / r.norm().item(), n)
                           for n, r in ref.items())
        b = next(iter(grad_batch.values())).shape[0]
        print(f"{phase} {label} B={b} grads, kernel path vs plain: global norm rel err "
              f"{norm_err:.3e} (tol {grad_tol[0]}), worst tensor rel err {worst:.3e} at {where} "
              f"(tol {grad_tol[1]})")
        check(norm_err <= grad_tol[0], f"{label} grad norm vs plain")
        check(worst <= grad_tol[1], f"{label} grad of {where} vs plain")

    # 1. the grads, before any step of the stage: a step moves the weights,
    # and AdamW's first, sign-like update turns the small differences
    # between the paths' grads (and the run-to-run order of the bf16
    # backward's dQ sums) into different weights, so a comparison after it
    # reads differently from run to run
    compare()

    # 2. the launches of one train step
    reset_counts()
    state, metrics = step(state, batch, SEED)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"{phase} {label}: one step, loss {metrics['loss'].item():.5f} grad_norm "
          f"{metrics['grad_norm'].item():.4f}, launches {counts} (expected {want})")
    check(counts == want, f"{label} train step launches {counts} != {want}")
    check(math.isfinite(metrics["loss"].item()), f"{label}: non-finite train loss")

    # 3. ten steps on one batch with one fixed draw
    fixed = make_train_step(lambda m, bt, g, train: loss_fn(m, bt, draws(SEED + 2), train),
                            run.tx, ema_decay=run.trainer_cfg.ema_decay)
    history = []
    for _ in range(steps):
        state, metrics = fixed(state, batch, SEED)
        history.append({k: v.item() for k, v in metrics.items()})
    for k in history[0]:
        seq = [h[k] for h in history]
        print(f"{phase} {label}: {steps} steps on one batch, {k} "
              f"{[round(x, 5) for x in seq]}")
        check(all(math.isfinite(x) for x in seq), f"{label}: non-finite {k} in {steps} steps")
        if k in falling:
            check(seq[-1] < seq[0], f"{label}: {k} did not fall over {steps} steps")

    # 4. step time and peak memory, kernel path vs plain path, in turns
    times, peaks = {"auto": [], "plain": []}, {}
    for backend in ("auto", "plain"):
        set_all(backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batch, SEED)  # warm-up, with the peak memory of a step
        torch.cuda.synchronize()
        peaks[backend] = torch.cuda.max_memory_allocated() / 2 ** 30
    for i in range(timed):
        for backend in (("auto", "plain") if i % 2 == 0 else ("plain", "auto")):
            set_all(backend)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch, SEED)
            torch.cuda.synchronize()
            times[backend].append((time.perf_counter() - t0) * 1e3)
    set_all("auto")
    bsz = next(iter(batch.values())).shape[0]
    STEP_MS[f"{phase} {label}"] = float(np.median(times["auto"]))
    for backend, name in (("auto", "kernel path"), ("plain", "plain path")):
        med = float(np.median(times[backend]))
        print(f"timing {phase} {label} B={bsz} {name}: step {med:.3f} ms median "
              f"({bsz / med * 1e3:.2f} samples/s), runs {[round(x, 3) for x in times[backend]]} "
              f"ms, peak memory {peaks[backend]:.2f} GiB | {smi}")

    # 5. one profiled step on the kernel path
    def one_step():
        nonlocal state
        state, _ = step(state, batch, SEED)

    if profile:
        profile_run(one_step, f"{phase} {label} step B={bsz} kernel path")
    return counts, state


def md17_train_phase(dev, smi, reset_counts, read_counts):
    """Phase 10: both MD17 training experiments at full width through the
    registry and the ported loader; returns the launches of one step of each
    stage."""
    from lam_slide_tpu_torch.data.loader import device_batch
    from lam_slide_tpu_torch.train import create_train_state, make_train_step

    run1 = md17_first_run(dev)

    # stage 1: per step K1 on the encoder's masked cross-attention (fp32,
    # the bias) and on the encoder's and the decoder's latent self-attention
    # (fp32), each with lse; K4 (fp32) on the same three, the cross one with
    # the bias (the bias and fp32 counters count each of K4's two kernels);
    # the decoder's output block has 32 queries and stays plain
    batch1 = device_batch(next(iter(run1.train_loader)), dev)
    check(batch1["pos"].shape == (MD17_S1_BATCH, MD17_ATOMS, 3),
          f"MD17 stage-1 batch {tuple(batch1['pos'].shape)}")
    counts = read_counts()
    want1 = {key: 0 for key in counts}
    cross = k4_f32_kernels(16, 192, MD17_ATOMS)  # the encoder's, with the bias
    want1.update({"K1": 3, "K1 bias": 1, "K1 fp32": 3, "K4 kv": 3, "K4 q": 3, "K4 bias": cross,
                  "K4 fp32": cross + 2 * k4_f32_kernels(16, 192, 192)})
    want1 = with_sm90(want1, k4_fp32_calls=3)
    counts1, _ = stage_checks(
        "stage 1", run1, batch1, batch1, want1, [run1.model], dev, smi, reset_counts,
        read_counts, S1_GRAD_REL_TOL, ("loss",))

    # stage 2 (the stage-1 weights are frozen now): per step the encode of
    # B*T frames under no_grad (K1 bias + K1 fp32), the DiT's forward and,
    # with checkpointing, its recompute in the backward (per layer K3 on the
    # spatial axis L=192 under K1's counter, K9 on the temporal axis T=30,
    # K2 on both axes' MLP branch, K7 twice), one K7 before the output
    # layer, then the aux decode of the prediction (fp32 K1 with lse on the
    # decoder's self-attention); backward: K4 bf16 per layer (K3's), K9's
    # backward per layer, K4 fp32 once (the decode)
    run2 = md17_second_run(run1, dev)
    ss = run2.second_stage
    d = MD17_DEPTH
    batch2 = device_batch(next(iter(run2.train_loader)), dev)
    check(batch2["pos"].shape == (MD17_BATCH, MD17_T, MD17_ATOMS, 3),
          f"MD17 stage-2 batch {tuple(batch2['pos'].shape)}")
    want2 = {key: 0 for key in counts}
    want2.update({"K1": 2 + 2 * d + 1, "K1 bias": 1, "K1 fp32": 3, "K2": 2 * 2 * d,
                  "K7": 2 * 2 * d + 1, "K9": 2 * d, "K9 bwd": d, "K4 kv": d + 1,
                  "K4 q": d + 1, "K4 fp32": k4_f32_kernels(16, 192, 192)})
    want2 = with_sm90(want2, k4_fp32_calls=1)
    grad_batch = {k: v[:GRAD_BATCH] for k, v in batch2.items()}
    counts2, state2 = stage_checks(
        "stage 2", run2, batch2, grad_batch, want2, [ss.backbone, ss.first_stage], dev, smi,
        reset_counts, read_counts, MD17_GRAD_REL_TOL, ("loss", "si_loss"))

    # the aux losses alone (the SI weight 0) for ten steps on the same batch
    # and draw, from a fresh optimizer state: their gradient through the
    # frozen stage 1 lowers their weighted sum. In the whole loss the SI
    # term dominates and pulls the prediction toward the encoded latents,
    # whose decoding by a random stage 1 is farther from the positions than
    # that of the initial prediction, so there pos_loss rises; alone, the
    # two aux terms trade against each other at equal weights, so only
    # their sum must fall (both seen on an H100).
    cfg2 = run2.config
    aux_loss = ss.make_loss(weight_si_loss=0.0, weight_pos_loss=cfg2.weight_pos_loss,
                            weight_inter_dist_loss=cfg2.weight_inter_dist_loss,
                            calc_additional_losses=True)
    aux_step = make_train_step(
        lambda m, bt, g, train: aux_loss(m, bt, torch.Generator(device=dev).manual_seed(SEED + 2),
                                         train),
        run2.tx, ema_decay=run2.trainer_cfg.ema_decay)
    aux_state = create_train_state(run2.model, run2.tx)
    history = []
    for _ in range(TRAIN_STEPS):
        aux_state, metrics = aux_step(aux_state, batch2, SEED)
        history.append({k: metrics[k].item() for k in ("loss", "pos_loss", "inter_dist_loss")})
    for k in history[0]:
        seq = [h[k] for h in history]
        print(f"md17_train stage 2: {TRAIN_STEPS} steps on the aux losses alone, {k} "
              f"{[round(x, 5) for x in seq]}")
        check(all(math.isfinite(x) for x in seq), f"stage 2 aux: non-finite {k}")
    check(history[-1]["loss"] < history[0]["loss"],
          "stage 2: the aux losses did not fall over ten steps")
    del aux_state

    # the sampled val hook on the EMA weights: K=5, Euler-10, one val batch
    # of each molecule
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        val = run2.eval_fns["val_sample"](state2, 0)
    torch.cuda.synchronize()
    print(f"md17_train stage 2: val hook on the EMA weights ({len(run2.val_loaders)} molecules, "
          f"K={MD17_K}): {val} in {time.perf_counter() - t0:.3f} s")
    check(all(math.isfinite(x) for x in val.values()), "non-finite val ADE/FDE")
    return counts1, counts2, (run2, batch2)


def k4_f32_kernels(dh: int, nq: int, nk: int) -> int:
    """Kernels of one fp32 K4 (or K6) call: the one-pass kernel and, where it
    keeps more than one key tile's dQ shares, their sum."""
    from lam_slide_tpu_torch.ops import flash_attention as fa

    return 1 + (fa.f32_dq_tiles(dh, nq, nk) > 1)


def f32_want(counts, *nonzero):
    """Every counter 0 but those the dicts ``nonzero`` give (later ones win),
    and the fp32 routes that follow (``with_routes``)."""
    want = {key: 0 for key in counts}
    for given in nonzero:
        want.update(given)
    return with_routes(want)


def fp32_train_phase(dev, smi, reset_counts, read_counts):
    """Phase 16: fp32 training on the card. Both registries' ``--smoke``
    stage 2 through ``train.cli`` in a temporary workspace (stage 1, then
    stage 2 from the run registry, one epoch each, val over one batch): every
    call returns 0, every metric is finite, and the stage-2 runs launch
    K8-fp32 and K9-fp32 forward and backward and no bf16 DiT kernel. Then
    the fp32 stage-2 train step at full width (``dit_dtype="float32"``): MD17
    (depth 4, hidden 256, T = 30, L = 192, B = 64, per-layer checkpointing)
    at 16 x dh 16 and 2 x dh 128, 4AA (depth 7, hidden 384, T = 1000, L = 2,
    B = 16; on perturbed weights) at 16 x dh 24 and 3 x dh 128, each through
    ``stage_checks`` with TF32 off: F32_TRAIN_STEPS steps in which the SI
    loss falls, F32_TIMED_STEPS timed steps of each path, a profiled step at
    16 heads.
    Returns the launches of one step of each full-width run, by label, and
    the MD17 16 x 16 run with its batch (phase 20's fp32 MD17 step)."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from lam_slide_tpu_torch.data.loader import device_batch
    from lam_slide_tpu_torch.experiments import registry
    from lam_slide_tpu_torch.train.cli import main as cli

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ws = tempfile.mkdtemp(prefix="fp32_train_")
    saved_env = os.environ.get("LAM_SLIDE_NO_DATA_CACHE")
    os.environ["LAM_SLIDE_NO_DATA_CACHE"] = "1"
    bf16_keys = ("K1 sm90", "K4 sm90", "K5 sm90", "K6 sm90", "K8 wmma")
    paired = ("K2", "K7", "K8", "K9", "K9 bwd")
    try:
        # 1. the --smoke runs of both registries through the CLI
        common = ["--workspace", ws, "--smoke", "--epochs", "1", "--set", "limit_val_batches=1"]
        for prefix, s1, s2 in (("md17", "ms1", "ms2"), ("peptide", "ps1", "ps2")):
            extra = ["--molecule", "aspirin"] if prefix == "md17" else []
            t0 = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc1 = cli(["--experiment", f"{prefix}_first_stage", "--run-id", s1, *common,
                           *extra])
                torch.cuda.synchronize()
                reset_counts()
                # MD17's --test: the fp32 rebuild's protocol over the test split
                rc2 = cli(["--experiment", f"{prefix}_second_stage", "--run-id", s2,
                           "--first-stage-run", s1, *common, *extra,
                           *(["--test"] if prefix == "md17" else [])])
                torch.cuda.synchronize()
            counts = read_counts()
            records = []
            for run_id in (s1, s2):
                with open(f"{ws}/{run_id}/metrics.jsonl") as f:
                    records += [json.loads(line) for line in f]
            bf16 = {k: counts[k] - counts[f"{k} fp32"] for k in paired}
            bf16.update({k: counts[k] for k in bf16_keys})
            print(f"fp32_train {prefix} --smoke: stage 1 and stage 2 in "
                  f"{time.perf_counter() - t0:.2f} s, return codes {rc1} {rc2}; records "
                  f"{records}; stage-2 launches {counts}")
            check((rc1, rc2) == (0, 0), f"fp32_train {prefix} --smoke: return codes {rc1} {rc2}")
            check(records and all(math.isfinite(v) for r in records for v in r.values()
                                  if isinstance(v, float)),
                  f"fp32_train {prefix} --smoke: a non-finite metric")
            check(all(counts[k] > 0 for k in ("K8 fp32", "K9 fp32", "K9 bwd fp32")),
                  f"fp32_train {prefix} --smoke: K8-fp32 or K9-fp32 (fwd, bwd) did not launch")
            check(not any(bf16.values()),
                  f"fp32_train {prefix} --smoke: a bf16 DiT kernel launched: {bf16}")

        # 2. the full-width fp32 train steps
        results = {}
        d = MD17_DEPTH
        run1 = registry.md17_first_stage(seed=SEED, molecule="aspirin",
                                         synthetic_frames=F32_MD17_FRAMES, device=dev)
        counts = read_counts()
        # per step: the encode (K1 bias + K1 latent self-attention, fp32),
        # the DiT's forward and its checkpointed recompute, the aux decode
        # (K1 fp32 with lse; K4-fp32 once)
        per_step = {"K1 bias": 1, "K4 kv": 1, "K4 q": 1, "K2": 4 * d, "K2 fp32": 4 * d,
                    "K2 fp32 tiled": 4 * d, "K7": 4 * d + 1, "K7 fp32": 4 * d + 1}
        # K6-fp32's kernels a layer: the spatial axis (L = 192) and the
        # temporal one (T = 30)
        md17_wide_kernels = (k4_f32_kernels(128, MD17_LATENTS, MD17_LATENTS)
                             + k4_f32_kernels(128, MD17_T, MD17_T))
        md17_want = {
            # the spatial axis (L = 192) through K3 (K1's counter), the
            # temporal one (T = 30) through K9, both fp32; K4-fp32 at dh 16
            # per layer and the decode's
            16: f32_want(counts, per_step, {
                "K1": 2 + 2 * d + 1, "K1 fp32": 2 + 2 * d + 1, "K9": 2 * d, "K9 fp32": 2 * d,
                "K9 bwd": d, "K9 bwd fp32": d, "K4 kv": d + 1, "K4 q": d + 1,
                "K4 fp32": (d + 1) * k4_f32_kernels(16, MD17_LATENTS, MD17_LATENTS)}),
            # both axes through K5-fp32 (the transform, then K1's register-tiled
            # kernel) and K6-fp32 (K4's wide kernel, and on the spatial axis
            # the sum of its dQ shares)
            MD17_WIDE_HEADS: f32_want(counts, per_step, {
                "K1": 3, "K1 fp32": 3, "K4 fp32": k4_f32_kernels(16, MD17_LATENTS, MD17_LATENTS),
                "K5": 4 * d, "K5 fp32": 4 * d,
                "K5 transform": 4 * d, "K5 fp32 wide": 4 * d, "K6": 2 * d,
                "K6 fp32": d * md17_wide_kernels, "K6 fp32 wide": d * md17_wide_kernels}),
        }
        md17_tp_run = None
        for heads in (16, MD17_WIDE_HEADS):
            run2 = registry.md17_second_stage(first_stage=run1, seed=SEED, molecule="aspirin",
                                              synthetic_frames=F32_MD17_FRAMES,
                                              dit_dtype="float32", num_heads=heads, device=dev)
            batch = device_batch(next(iter(run2.train_loader)), dev)
            check(batch["pos"].shape[:2] == (MD17_BATCH, MD17_T),
                  f"MD17 fp32 stage-2 batch {tuple(batch['pos'].shape)}")
            ss = run2.second_stage
            label = f"md17 {heads}x{256 // heads}"
            results[label], _ = stage_checks(
                label, run2, batch, {k: v[:GRAD_BATCH] for k, v in batch.items()},
                md17_want[heads], [ss.backbone, ss.first_stage], dev, smi, reset_counts,
                read_counts, F32_TRAIN_GRAD_REL_TOL, ("si_loss",), "fp32_train",
                F32_TRAIN_STEPS, F32_TIMED_STEPS, profile=heads == 16)
            if heads == 16:
                md17_tp_run = (run2, batch)  # phase 20's fp32 MD17 step at tp 2
            del run2, batch, ss
            torch.cuda.empty_cache()
        del run1

        run1 = registry.peptide_first_stage(seed=SEED, synthetic_peptides=F32_PEP_PEPTIDES,
                                            synthetic_frames=F32_PEP_FRAMES, device=dev)
        # per step (no checkpointing): per layer K8-fp32 on the spatial axis
        # (L = 2), K2-fp32 and two K7-fp32, and one K7-fp32 before the output
        # layer; the temporal axis (T = 1000) through K3-fp32 (K1's counter)
        # and K4-fp32 at 16 x 24, K5-fp32 and K6-fp32 at 3 x 128; the aux
        # decode's attention (fewer than 128 queries) is plain
        per_step = {"K2": DEPTH, "K2 fp32": DEPTH, "K2 fp32 tiled": DEPTH,
                    "K7": 2 * DEPTH + 1, "K7 fp32": 2 * DEPTH + 1, "K8": DEPTH, "K8 fp32": DEPTH}
        pep_want = {
            HEADS: f32_want(counts, per_step, {
                "K1": DEPTH, "K1 fp32": DEPTH, "K4 kv": DEPTH, "K4 q": DEPTH,
                "K4 fp32": DEPTH * k4_f32_kernels(HIDDEN // HEADS, T, T)}),
            WIDE_HEADS: f32_want(counts, per_step, {
                "K5": DEPTH, "K5 fp32": DEPTH, "K5 transform": DEPTH, "K5 fp32 wide": DEPTH,
                "K6": DEPTH, "K6 fp32": DEPTH * k4_f32_kernels(128, T, T),
                "K6 fp32 wide": DEPTH * k4_f32_kernels(128, T, T)}),
        }
        for heads in (HEADS, WIDE_HEADS):
            run2 = registry.peptide_second_stage(
                first_stage=run1, seed=SEED, synthetic_peptides=F32_PEP_PEPTIDES,
                synthetic_frames=F32_PEP_FRAMES, repeats=F32_PEP_REPEATS, dit_dtype="float32",
                num_heads=heads, device=dev)
            batch = device_batch(next(iter(run2.train_loader)), dev)
            check(tuple(batch["atom14_pos"].shape[:2]) == (TRAIN_BATCH, T),
                  f"4AA fp32 stage-2 batch {tuple(batch['atom14_pos'].shape)}")
            ss = run2.second_stage
            label = f"4AA {heads}x{HIDDEN // heads}"
            perturb_(run2.model, SEED)  # the reference init makes every block the identity
            results[label], _ = stage_checks(
                label, run2, batch, {k: v[:GRAD_BATCH] for k, v in batch.items()},
                pep_want[heads], [ss.backbone, ss.first_stage], dev, smi, reset_counts,
                read_counts, F32_TRAIN_GRAD_REL_TOL, ("si_loss",), "fp32_train",
                F32_TRAIN_STEPS, F32_TIMED_STEPS, profile=heads == HEADS)
            del run2, batch, ss
            torch.cuda.empty_cache()
        return results, md17_tp_run
    finally:
        shutil.rmtree(ws, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("LAM_SLIDE_NO_DATA_CACHE", None)
        else:
            os.environ["LAM_SLIDE_NO_DATA_CACHE"] = saved_env
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_inputs(batch: int, dev, gen):
    noise = torch.randn(batch, T, L, DIN, generator=gen).to(dev)
    x_cond = torch.zeros_like(noise)
    mask = torch.zeros(batch, T, L, dtype=torch.long, device=dev)
    mask[:, :1] = 1  # frame 0 conditions, as bench.py:121-123
    return noise, x_cond, mask


def solve_time_s(solve, noise, kw) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    solve(noise, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def _device_time_us(evt) -> float:
    # the attribute's name differs across torch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_run(run, label: str) -> None:
    """One run (a solve or a train step) under torch.profiler: host wall time
    around the synchronized run (inflated by the profiler), summed device
    kernel time, the device's idle share, kernel launches and the kernels
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # "Command Buffer Full" marks the host waiting on a full launch queue: it
    # overlaps the kernels and is no device work
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != QUEUE_FULL]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    check(busy_us > 0, f"profile {label}: no device time traced")
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms (profiled), device kernel "
          f"time {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}, "
          f"kernel launches {len(kernels)}")
    top = [e for e in prof.key_averages() if e.key != QUEUE_FULL]
    for evt in sorted(top, key=_device_time_us, reverse=True)[:PROFILE_TOP]:
        print(f"  {_device_time_us(evt) / 1e3:9.3f} ms device {evt.count:6d} calls  {evt.key[:90]}")


def si_loss_fn(transport):
    """The 4AA stage-2 SI loss (tools/measure_train_loop.py "4aa"): the mean
    of the GVP data-prediction interpolant loss; t and x0 are drawn from the
    step's generator unless the batch fixes them."""

    def loss_fn(model, batch, generator, train):
        out = transport.training_losses(
            model, batch["x1"], {"x_cond": batch["x_cond"], "x_cond_mask": batch["mask"]},
            generator=generator, t=batch.get("t"), x0=batch.get("x0"))
        loss = out["loss"].mean()
        return loss, {"si_loss": loss}

    return loss_fn


def train_batch(batch: int, dev, transport, fixed_draws: bool, seed: int):
    """Random latents from the seed, frame 0 conditioning (x_cond carries it,
    so every parameter, cond_to_emb included, gets a grad); with
    ``fixed_draws`` the batch also fixes the interpolant's t and x0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x1 = torch.randn(batch, T, L, DIN, generator=gen, device=dev)
    mask = torch.zeros(batch, T, L, dtype=torch.long, device=dev)
    mask[:, :1] = 1
    out = {"x1": x1, "x_cond": x1 * mask[..., None], "mask": mask}
    if fixed_draws:
        out["t"], out["x0"], _ = transport.sample(x1, gen)
    return out


def train_state(make_model, heads, backend="auto", mesh=None, dtype=torch.bfloat16):
    from lam_slide_tpu_torch.train import create_train_state, make_train_step
    from lam_slide_tpu_torch.train.trainer import TrainerConfig, make_optimizer
    from lam_slide_tpu_torch.transport import create_transport

    cfg = TrainerConfig(max_epochs=TRAIN_EPOCHS, lr=1e-3, grad_clip=CLIP, ema_decay=EMA_DECAY)
    tx, _ = make_optimizer(cfg, 1)
    model = make_model(heads, dtype=dtype, backend=backend)
    transport = create_transport(path_type="GVP", prediction="data")
    step = make_train_step(si_loss_fn(transport), tx, ema_decay=cfg.ema_decay, mesh=mesh)
    return create_train_state(model, tx), step, transport


def _global_norm(grads):
    return math.sqrt(sum(g.double().square().sum().item() for g in grads.values()))


def train_checks(dev, make_model, reset_counts, read_counts):
    """Phase 7 at both splits; returns the launches of one step per split."""
    counts_by_split = {}
    for heads in (HEADS, WIDE_HEADS):
        split = f"{heads}x{HIDDEN // heads}"
        state, step, transport = train_state(make_model, heads)
        model, loss_fn = state.model, si_loss_fn(transport)
        batch = train_batch(TRAIN_BATCH, dev, transport, False, SEED)

        # 1. launches of one train step at B=16
        reset_counts()
        state, metrics = step(state, batch, SEED)
        torch.cuda.synchronize()
        counts = read_counts()
        counts_by_split[heads] = counts
        nr = HIDDEN // heads % 128 == 0
        want = {key: 0 for key in counts}
        want.update({"K2": DEPTH, "K7": 2 * DEPTH + 1, "K8": DEPTH})
        want.update({"K5": DEPTH, "K6": DEPTH} if nr else
                    {"K1": DEPTH, "K4 kv": DEPTH, "K4 q": DEPTH})
        want = with_sm90(want)
        print(f"train {split} B={TRAIN_BATCH}: one step, loss {metrics['loss'].item():.5f} "
              f"grad_norm {metrics['grad_norm'].item():.4f}, launches {counts} (expected {want})")
        check(counts == want, f"train step launches {counts} != {want}")
        check(math.isfinite(metrics["loss"].item()), "non-finite train loss")

        # 2. every parameter's grad finite and non-zero after a backward
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch, torch.Generator(device=dev).manual_seed(SEED), True)[0].backward()
        bad = [n for n, p in model.named_parameters() if p.grad is None
               or not bool(torch.isfinite(p.grad).all()) or not p.grad.abs().max().item() > 0]
        n_params = len(list(model.parameters()))
        print(f"train {split} B={TRAIN_BATCH}: {n_params - len(bad)} of {n_params} parameters "
              f"have a finite, non-zero grad")
        check(not bad, f"parameters without a finite, non-zero grad: {bad}")
        model.zero_grad(set_to_none=True)

        # 3. grads at B=2: kernel path vs plain path, bf16 and a float32 copy
        gb = train_batch(GRAD_BATCH, dev, transport, True, SEED + 1)

        def grads_of(m):
            m.zero_grad(set_to_none=True)
            loss_fn(m, gb, None, True)[0].backward()
            grads = {n: p.grad.detach().float().clone() for n, p in m.named_parameters()}
            m.zero_grad(set_to_none=True)
            return grads

        got = grads_of(model)
        model.backend = "plain"
        refs = {"bf16": grads_of(model)}
        model.backend = "auto"
        ref32 = make_model(heads, torch.float32, "plain")
        ref32.load_state_dict(model.state_dict())
        refs["fp32"] = grads_of(ref32)
        del ref32
        for name, ref in refs.items():
            norm_err = abs(_global_norm(got) - _global_norm(ref)) / _global_norm(ref)
            worst, where = max(((got[n] - r).norm().item() / r.norm().item(), n)
                               for n, r in ref.items())
            print(f"train {split} B={GRAD_BATCH} grads, kernel path vs plain {name}: global norm "
                  f"rel err {norm_err:.3e} (tol {GRAD_NORM_REL_TOL[name]}), worst tensor rel "
                  f"err {worst:.3e} at {where} (tol {GRAD_TENSOR_REL_TOL[name]})")
            check(norm_err <= GRAD_NORM_REL_TOL[name], f"{split} grad norm vs plain {name}")
            check(worst <= GRAD_TENSOR_REL_TOL[name], f"{split} grad of {where} vs plain {name}")

        # 4. ten steps on one fixed batch (t and x0 fixed too)
        fixed = train_batch(TRAIN_BATCH, dev, transport, True, SEED + 2)
        ema0 = {k: v.clone() for k, v in state.ema_params.items()}
        losses = []
        for _ in range(TRAIN_STEPS):
            state, metrics = step(state, fixed, SEED)
            losses.append(metrics["loss"].item())
        ema_moved = math.sqrt(sum((state.ema_params[k] - v).double().square().sum().item()
                                  for k, v in ema0.items()))
        print(f"train {split} B={TRAIN_BATCH}: {TRAIN_STEPS} steps on one fixed batch, SI loss "
              f"{[round(x, 5) for x in losses]}; EMA moved by {ema_moved:.4e} (L2)")
        check(all(math.isfinite(x) for x in losses), "non-finite loss in ten steps")
        check(losses[-1] < losses[0], f"{split}: the SI loss did not fall over ten steps")
        check(ema_moved > 0, f"{split}: the EMA did not move")
        del state, model
        torch.cuda.empty_cache()
    return counts_by_split


def train_timing(dev, make_model, smi) -> None:
    """Phase 8: train-step times at B=16 per split on the kernel path and the
    plain path (at 16 x 24 also the kernel path with per-layer
    checkpointing), then one profiled step per split on the kernel path."""
    for heads in (HEADS, WIDE_HEADS):
        split = f"{heads}x{HIDDEN // heads}"
        arms = {"kernel path": ("auto", False), "plain path": ("plain", False)}
        if heads == HEADS:
            arms["kernel path, checkpointing"] = ("auto", True)
        runs = {}
        for label, (backend, checkpointing) in arms.items():
            state, step, transport = train_state(make_model, heads, backend)
            state.model.checkpointing = checkpointing
            batch = train_batch(TRAIN_BATCH, dev, transport, False, SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):  # warm-up, with the peak memory of a step
                state, _ = step(state, batch, SEED)
            torch.cuda.synchronize()
            runs[label] = dict(state=state, step=step, batch=batch, times=[],
                               peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        for i in range(TIMED_STEPS):  # the arms in turn, in reverse order every other round
            for label in (list(runs) if i % 2 == 0 else list(reversed(runs))):
                run = runs[label]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run["state"], _ = run["step"](run["state"], run["batch"], SEED)
                torch.cuda.synchronize()
                run["times"].append((time.perf_counter() - t0) * 1e3)
        for label, run in runs.items():
            med = float(np.median(run["times"]))
            print(f"timing train {split} B={TRAIN_BATCH} {label}: step {med:.3f} ms median "
                  f"({TRAIN_BATCH / med * 1e3:.2f} samples/s), runs "
                  f"{[round(x, 3) for x in run['times']]} ms, peak memory {run['peak']:.2f} GiB "
                  f"| {smi}")
        run = runs["kernel path"]

        def one_step():
            run["state"], _ = run["step"](run["state"], run["batch"], SEED)

        profile_run(one_step, f"train step {split} kernel path B={TRAIN_BATCH}")
        del runs, run
        torch.cuda.empty_cache()


def ablation_phase(dev, smi, reset_counts, read_counts):
    """Phase 11: the paths of K10 and K11, through the entry points the JAX
    package gives them. K10: the 4AA temporal block
    ``ParallelMLPAttention(hidden 384, 3 heads, mlp_ratio 2,
    fused_temporal=True)`` on x [B*L = 16, T = 1000, 384] bf16: launches of one
    forward and of one forward + backward, the forward and the grads against
    the block's plain path on the same weights, and its time against the same
    block on the K5 route. K11: ``flash_backward_short`` at the MD17 stage-2
    spatial axis [1920, 16, 192, 16] bf16 from a K1 forward's out and lse.
    Returns the launches of the K10 forward + backward and of the K11 call."""
    from lam_slide_tpu_torch.models.latent_dit import ParallelMLPAttention, rope_cos_sin
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops.ablations import short_backward as tsb

    bf, d, n = torch.bfloat16, HIDDEN, SAMPLER_BATCH * L
    dh = d // WIDE_HEADS

    def block(fused):
        return ParallelMLPAttention(d, WIDE_HEADS, MLP_RATIO, False, 8, bf,
                                    torch.Generator().manual_seed(SEED),
                                    fused_temporal=fused).to(dev)

    fused, k5_route = block(True), block(False)
    k5_route.load_state_dict(fused.state_dict())
    gen = torch.Generator().manual_seed(SEED + 6)
    x = _rand(gen, n, T, d).to(dev, bf)
    g = _rand(gen, n, T, d).to(dev, bf)
    cos, sin = rope_cos_sin(T, dh, device=dev)

    with torch.no_grad():
        reset_counts()
        got = fused(x, cos, sin)
        torch.cuda.synchronize()
        fwd_counts = read_counts()
        want = fused(x, cos, sin, backend="plain")
        via_k5 = k5_route(x, cos, sin)
    want_counts = {key: 0 for key in fwd_counts}
    want_counts.update({"K10": 1, "K2": 1})
    want_counts = with_sm90(want_counts)
    _, rel = errors(got, want)
    _, rel5 = errors(got, via_k5)
    print(f"ablation: fused temporal block 3x128 x [{n},{T},{d}] forward: launches {fwd_counts} "
          f"(expected {want_counts}); vs the plain path rel {rel:.3e}, vs the K5 route rel "
          f"{rel5:.3e} (tol {BLOCK_REL_TOL})")
    check(fwd_counts == want_counts, f"fused temporal block launches {fwd_counts}")
    check(rel <= BLOCK_REL_TOL and rel5 <= BLOCK_REL_TOL, "fused temporal block output")

    def grads(backend):
        fused.zero_grad(set_to_none=True)
        xg = x.detach().clone().requires_grad_()
        (fused(xg, cos, sin, backend=backend).float() * g.float()).sum().backward()
        out = {"x": xg.grad.float()}
        out.update({nm: p_.grad.float().clone() for nm, p_ in fused.named_parameters()})
        return out

    reset_counts()
    got_g = grads("auto")
    torch.cuda.synchronize()
    counts = read_counts()
    want_g = grads("plain")
    check(counts == want_counts, f"fused temporal block fwd+bwd launches {counts}")
    worst, where = max(((got_g[nm] - w).norm().item() / w.norm().item(), nm)
                       for nm, w in want_g.items())
    bad = [nm for nm, gr in got_g.items() if not bool(torch.isfinite(gr).all())
           or not gr.abs().max().item() > 0]
    print(f"ablation: fused temporal block forward + backward: launches {counts}; grads (x and "
          f"{len(want_g) - 1} parameters) vs the plain path: worst tensor rel err {worst:.3e} at "
          f"{where} (tol {GRAD_TENSOR_REL_TOL['bf16']})")
    check(not bad, f"fused temporal block grads not finite and non-zero: {bad}")
    check(worst <= GRAD_TENSOR_REL_TOL["bf16"], f"fused temporal block grad of {where}")
    fused.zero_grad(set_to_none=True)

    def fwd_bwd(mod):
        def run():
            xg = x.detach().clone().requires_grad_()
            (mod(xg, cos, sin).float() * g.float()).sum().backward()
        return run

    with torch.no_grad():
        times = {"K10 route": time_ms(lambda: fused(x, cos, sin)),
                 "K5 route": time_ms(lambda: k5_route(x, cos, sin))}
    times.update({"K10 route fwd+bwd": time_ms(fwd_bwd(fused), reps=5),
                  "K5 route fwd+bwd": time_ms(fwd_bwd(k5_route), reps=5)})
    print("timing ablation: fused temporal block 3x128 B*L=16: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()) + f" | {smi}")
    del fused, k5_route, got_g, want_g
    torch.cuda.empty_cache()

    # K11 at the MD17 stage-2 spatial axis through its entry point
    b, h, nn_, hd = MD17_BATCH * MD17_T, 16, 192, 16
    qkv = _rand(gen, b, nn_, 3 * h * hd).to(dev, bf)
    q, k, v = (t_.transpose(1, 2) for t_ in qkv.unflatten(-1, (3, h, hd)).unbind(2))
    gk = _rand(gen, b, h, nn_, hd).to(dev, bf)
    out, lse = fa._forward(q, k, v, hd ** -0.5, with_lse=True)
    torch.cuda.synchronize()
    reset_counts()
    dq, dk, dv = tsb.flash_backward_short(q, k, v, out, lse, gk, hd ** -0.5)
    torch.cuda.synchronize()
    k11_counts = read_counts()
    finite = all(bool(torch.isfinite(t_).all()) for t_ in (dq, dk, dv))
    print(f"ablation: flash_backward_short [{b},{h},{nn_},{hd}] bf16: launches {k11_counts}, "
          f"finite={finite}")
    check(finite and k11_counts["K11"] == 1 and sum(k11_counts.values()) == 1,
          f"K11 path launches {k11_counts}")
    del qkv, q, k, v, gk, out, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return counts, k11_counts


def sampler_phase(dev, make_model, smi, reset_counts, read_counts):
    """Phase 12: the SDE sampler and the likelihood solve on the full-width
    4AA 16 x 24 DiT: one ``get_sample_fn("SDE")`` solve (the reference's
    defaults: Euler-Maruyama, the linear diffusion, the Mean last step, 250
    steps) and one ``sample_ode_likelihood`` solve (Euler, 50 steps, one drift
    VJP per step) at B=8 through the kernels, with the launches of every
    kernel per solve, finite outputs and both solve times; then the kernel
    path against the plain path on the same noise and eps at B=2 with fewer
    steps. Returns the launches of both solves."""
    from lam_slide_tpu_torch.transport import Sampler, create_transport

    model = make_model(HEADS)
    sampler = Sampler(create_transport(path_type="GVP", prediction="data"))
    sde = sampler.get_sample_fn("SDE")
    like = sampler.sample_ode_likelihood()
    gen = torch.Generator().manual_seed(SEED + 7)
    noise, x_cond, mask = make_inputs(SAMPLER_BATCH, dev, gen)
    kw = dict(x_cond=x_cond, x_cond_mask=mask)

    def cuda_gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # per drift evaluation of a forward: K1 (via K3) 7, K2 7, K7 15, K8 7; the
    # SDE drift evaluates the model twice (drift and score), over 249 grid
    # steps and the Mean last step; the likelihood once per step with its VJP
    # (K4's two kernels per layer)
    fwd = {"K1": DEPTH, "K2": DEPTH, "K7": 2 * DEPTH + 1, "K8": DEPTH}
    results = {}
    for name, run, evals, vjp in (
            ("SDE", lambda: sde(cuda_gen(SEED), noise, model, **kw), 2 * SDE_STEPS, False),
            ("likelihood", lambda: like(cuda_gen(SEED + 1), noise, model, **kw),
             LIKELIHOOD_STEPS - 1, True)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        want = {key: 0 for key in counts}
        want.update({key: n_ * evals for key, n_ in fwd.items()})
        if vjp:
            want.update({"K4 kv": DEPTH * evals, "K4 q": DEPTH * evals})
        want = with_sm90(want)
        outs = out if isinstance(out, tuple) else (out,)
        finite = all(bool(torch.isfinite(t_).all()) for t_ in outs)
        shapes = [list(t_.shape) for t_ in outs]
        print(f"samplers: {name} solve 16x24 B={SAMPLER_BATCH}: outputs {shapes} finite={finite} "
              f"in {secs:.3f} s ({SAMPLER_BATCH * evals / secs:.2f} traj-drift-evals/s); "
              f"launches {counts} (expected {want}) | {smi}")
        check(finite, f"{name}: non-finite output")
        check(counts == want, f"{name} launches {counts} != {want}")
        results[name] = counts
        del out, outs

    # kernel path vs plain path at B=2 on the same noise and eps
    noise2, x_cond2, mask2 = make_inputs(2, dev, gen)
    kw2 = dict(x_cond=x_cond2, x_cond_mask=mask2)
    sde2 = sampler.get_sample_fn("SDE", {"num_steps": SOLVE_CMP_STEPS[0]})
    like2 = sampler.sample_ode_likelihood(num_steps=SOLVE_CMP_STEPS[1])
    paths = {}
    for backend in ("auto", "plain"):
        model.backend = backend
        paths[backend] = (sde2(cuda_gen(SEED + 2), noise2, model, **kw2),
                          *like2(cuda_gen(SEED + 3), noise2, model, **kw2))
    model.backend = "auto"
    for name, got, want in zip(("SDE x", "likelihood logp", "likelihood z"), paths["auto"],
                               paths["plain"]):
        abs_err, rel = errors(got, want)
        print(f"samplers: {name} at B=2 ({SOLVE_CMP_STEPS} steps), kernel vs plain path: "
              f"max_abs_err {abs_err:.3e} rel {rel:.3e} (tol {SOLVE_REL_TOL}); max|plain| "
              f"{want.abs().max().item():.4f}")
        check(rel <= SOLVE_REL_TOL, f"{name}: kernel vs plain rel err {rel}")
    del model
    torch.cuda.empty_cache()
    return results


def dit_variants_phase(dev, reset_counts, read_counts):
    """Phase 13: one forward of the 4AA-width DiT (depth 7, hidden 384, 16 x
    24, B=2) with ``attention_mode="linear"`` and one with
    ``share_weights=True``, and one of the DiT at the tiny test registries'
    width (hidden 32, 4 x dh 8), whose spatial blocks take K8's WMMA route,
    each against its plain path on the same weights, with the launches of
    each kernel. Returns the tiny DiT's launches."""
    from lam_slide_tpu_torch.models import LatentDiT

    gen = torch.Generator().manual_seed(SEED + 8)
    noise, x_cond, mask = make_inputs(2, dev, gen)
    tvec = torch.full((2,), 0.5, device=dev)
    linear_launches = {"K2": 2 * DEPTH, "K7": 2 * DEPTH + 1}
    shared_launches = {"K1": DEPTH, "K2": DEPTH, "K7": 2 * DEPTH + 1, "K8": DEPTH}
    tiny_launches = dict(shared_launches, **{"K8 wmma": DEPTH})
    for label, kw, launches in (("linear", dict(attention_mode="linear"), linear_launches),
                                ("share_weights", dict(share_weights=True), shared_launches),
                                ("hidden 32, 4 x 8", dict(hidden_size=32, num_heads=4),
                                 tiny_launches)):
        kw = dict(dict(hidden_size=HIDDEN, num_heads=HEADS), **kw)
        model = LatentDiT(depth=DEPTH, in_dim=DIN, mlp_ratio=MLP_RATIO, reference_init=False,
                          dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(SEED), **kw)
        with torch.no_grad():
            reset_counts()
            got = model(noise, tvec, x_cond, mask)
            torch.cuda.synchronize()
            counts = read_counts()
            model.backend = "plain"
            want_out = model(noise, tvec, x_cond, mask)
        want = {key: 0 for key in counts}
        want.update(launches)
        want = with_sm90(want)
        _, rel = errors(got, want_out)
        print(f"dit_variants: {label} forward B=2: launches {counts} (expected {want}); "
              f"kernel vs plain rel {rel:.3e} (tol {MODEL_REL_TOL}); finite="
              f"{bool(torch.isfinite(got).all())}")
        check(counts == want, f"{label} launches {counts} != {want}")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        check(rel <= MODEL_REL_TOL, f"{label}: kernel vs plain rel err {rel}")
        del model
    return counts


def _host_batch(loader, reps=HOST_REPS):
    """Median ms over ``reps`` of one batch made as the Loader's producer
    makes it (the dataset's whole-batch path where the Loader takes it, else
    ``sample`` + the collate), on the first batch's indices and a fresh draw
    of the same seed each time; -> (ms, the last batch, whole-batch?)."""
    from lam_slide_tpu_torch.data.loader import _is_canonical_collate

    ds = loader.dataset
    batched = getattr(ds, "sample_batch", None)
    if batched is not None and not _is_canonical_collate(loader.collate_fn, ds):
        batched = None
    idx = next(loader._batch_indices(np.random.default_rng((loader.seed, 0))))
    times = []
    for _ in range(reps):
        rng = np.random.default_rng((loader.seed, 1))
        t0 = time.perf_counter()
        batch = (batched(idx, rng) if batched is not None
                 else loader.collate_fn([ds.sample(int(i), rng) for i in idx]))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), batch, batched is not None


def host_batch_times(dev, smi):
    """Phase 18's loader timing: the host batch of the MD17 stage-1 loader
    (B=256), the MD17 stage-2 loaders (B=64: the registry's train loader
    over the 8 molecules, and one molecule's, the val and test loaders'
    whole-batch path) and the NBA stage-2 loader (B=1024, the registry's
    64 synthetic games), on the native engine (the default) and on the numpy
    forms (LAM_SLIDE_NO_NATIVE=1), beside the kernel-path step times of
    phases 10 and 17. The routes' batches agree (integers bit for bit,
    floats within HOST_FLOAT_TOL), and the engine's counter moves on the
    whole-batch loaders."""
    import functools
    import os

    from lam_slide_tpu_torch import native
    from lam_slide_tpu_torch.composites.nba import NBAFirstStageConfig
    from lam_slide_tpu_torch.data.collate import pad_collate_temporal
    from lam_slide_tpu_torch.data.loader import Loader
    from lam_slide_tpu_torch.data.md17 import MD17Dataset
    from lam_slide_tpu_torch.data.nba import NBADataset
    from lam_slide_tpu_torch.experiments import registry

    md17_s1 = md17_first_run(dev).train_loader
    molecules = list(registry.MD17_SCALES)[:-1]
    train_sets, _ = registry._md17_datasets(False, None, False, molecules, MD17_ATOMS, MD17_T,
                                            registry.MD17_SCALES,
                                            synthetic_frames=MD17_FRAMES)
    collate = functools.partial(pad_collate_temporal, num_entities=MD17_ATOMS)
    md17_s2 = Loader(registry._ConcatDataset(train_sets), MD17_BATCH, collate, seed=SEED)
    aspirin = MD17Dataset(molecule="aspirin", mode="test", span=MD17_T, first_stage=False,
                          num_entities=MD17_ATOMS, scale=registry.MD17_SCALES["aspirin"],
                          rand_rotation=False, synthetic_frames=MD17_FRAMES)
    md17_one = Loader(aspirin, MD17_BATCH, collate, seed=SEED)
    n_nba = NBAFirstStageConfig().num_entities

    def nba_loader():  # the route is fixed when the dataset is built
        ds = NBADataset(scene="score", flip=True, rand_rotation=True, split="train",
                        num_entities=n_nba, first_stage=False,
                        shift=registry.NBA_SHIFT["score"], scale=registry.NBA_SCALE["score"],
                        synthetic_games=64)
        return Loader(ds, 1024, functools.partial(pad_collate_temporal, num_entities=n_nba),
                      seed=SEED)

    cases = [("md17 stage 1", lambda: md17_s1, "md17_train stage 1"),
             ("md17 stage 2 (8 molecules)", lambda: md17_s2, "md17_train stage 2"),
             ("md17 stage 2 (aspirin, val/test)", lambda: md17_one, "md17_train stage 2"),
             ("nba stage 2", nba_loader, "ped_nba_loop nba stage 2")]
    for label, make, step_key in cases:
        native.calls = 0
        ms_engine, got, whole = _host_batch(make())
        calls = native.calls
        os.environ["LAM_SLIDE_NO_NATIVE"] = "1"
        try:
            ms_numpy, want, _ = _host_batch(make())
        finally:
            del os.environ["LAM_SLIDE_NO_NATIVE"]
        check(set(got) == set(want), f"trajio host batch {label}: keys differ")
        worst = 0.0
        for k, w in want.items():
            g = got[k]
            check(g.dtype == w.dtype and g.shape == w.shape, f"trajio {label}: {k} differs")
            if w.dtype.kind == "f":
                check(np.allclose(g, w, rtol=HOST_FLOAT_TOL, atol=HOST_FLOAT_TOL),
                      f"trajio {label}: {k} engine vs numpy")
                worst = max(worst, float(np.abs(g - w).max()))
            else:
                check(np.array_equal(g, w), f"trajio {label}: {k} engine vs numpy")
        check(calls > 0 if whole else calls == 0,
              f"trajio {label}: {calls} engine calls (whole-batch path: {whole})")
        bsz = make().batch_size
        step = STEP_MS.get(step_key)
        check(step is not None, f"trajio: no step time of {step_key}")
        print(f"timing trajio host batch {label} B={bsz} "
              f"({'whole-batch' if whole else 'per sample + collate'}): engine "
              f"{ms_engine:.3f} ms ({calls} engine calls), numpy {ms_numpy:.3f} ms, median of "
              f"{HOST_REPS}; max |engine - numpy| {worst:.3e} (tol {HOST_FLOAT_TOL}); the "
              f"{step_key} kernel-path step {step:.3f} ms | host of {smi}")


def trajio_phase(dev, smi, reset_counts, read_counts):
    """Phase 18: raw MD files through the port's process_4aa into the 4AA CLI
    at full width, the loaders' host batch on the engine and on numpy, and
    one smoke sweep. Writes 8 train peptides of PEP_S2_FRAMES frames and one
    held-out peptide (tools/synthetic_md.py) as XTC, DCD and multi-model PDB
    trajectories beside PDB topologies with hydrogens; runs
    ``python -m lam_slide_tpu_torch.tools.process_4aa``'s ``main`` on each
    split and checks that the hydrogens are gone, that each npz is the
    decoded frames after ``superpose_center`` (bit for bit) and the written
    ones within the codec's bound carried through the fit, and that each
    state0 PDB parses; trains ``train.cli`` stage 1 (fp32, B=512, three
    steps, val) and stage 2 (the bf16 DiT of depth 7, hidden 384, 16 x 24,
    T=1000, L=2, B=16, three steps, val) with ``--data-root`` on the
    processed files: return codes, finite metric streams, stage 2's launches
    of K1/K3, K2, K4, K7 and K8 (as phase 15 reads them), step times. Then
    ``host_batch_times`` and ``sweeps.run_sweep("peptide", smoke=True)``
    in-process."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from lam_slide_tpu_torch import native
    from lam_slide_tpu_torch.data.peptide import parse_pdb_topology, superpose_center
    from lam_slide_tpu_torch.data.trajio import load_traj
    from lam_slide_tpu_torch.experiments import sweeps
    from lam_slide_tpu_torch.tools import process_4aa
    from lam_slide_tpu_torch.tools.synthetic_md import write_raw_peptide
    from lam_slide_tpu_torch.train.cli import main as cli

    check(native.available(), "trajio: LAM_SLIDE_NO_NATIVE=1 turns off the engine it runs")
    ws = tempfile.mkdtemp(prefix="trajio_")
    saved_env = os.environ.get("LAM_SLIDE_NO_DATA_CACHE")
    os.environ["LAM_SLIDE_NO_DATA_CACHE"] = "1"  # leave no files
    try:
        # 1. raw MD files, the three formats by turns
        t0 = time.perf_counter()
        sims, root = f"{ws}/sims", f"{ws}/data"
        splits = {"train": [f"raw{i}" for i in range(TRAJIO_TRAIN)], "val": ["rawval"]}
        written = {}
        for i, name in enumerate(splits["train"] + splits["val"]):
            fmt = TRAJIO_FORMATS[i % len(TRAJIO_FORMATS)]
            written[name] = (fmt, *write_raw_peptide(sims, name, fmt, PEP_S2_FRAMES,
                                                     precision=TRAJIO_PRECISION))
        t1 = time.perf_counter()

        # 2. process_4aa on each split (stride 1); the test split is the val
        # peptide again, so no loader falls back to synthetic peptides
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            for split, names in splits.items():
                with open(f"{ws}/{split}.csv", "w") as f:
                    f.write("name\n" + "".join(f"{n}\n" for n in names))
                process_4aa.main(["--split", f"{ws}/{split}.csv", "--sim-dir", sims,
                                  "--outdir", f"{root}/{split}", "--stride", "1"])
        shutil.copytree(f"{root}/val", f"{root}/test")
        t2 = time.perf_counter()
        check(out.getvalue().split() == [w for n in splits["train"] + splits["val"]
                                         for w in ("done", n)],
              f"trajio: process_4aa printed {out.getvalue()!r}")
        worst = {fmt: [0.0, 0.0, 0.0] for fmt in TRAJIO_FORMATS}  # codec, fit, bound
        for name, (fmt, frames, heavy) in written.items():
            split = "val" if name in splits["val"] else "train"
            decoded = load_traj(f"{sims}/{name}/{name}.{fmt}", pdb_unit="nm")
            npz = np.load(f"{root}/{split}/{name}-traj-arrays.npz")["positions"]
            residues = parse_pdb_topology(f"{root}/{split}/{name}-traj-state0.pdb")
            with open(f"{root}/{split}/{name}-traj-state0.pdb") as f:
                atom_names = [line[12:16].strip() for line in f if line.startswith("ATOM")]
            bound = TRAJIO_CODEC_BOUND[fmt] + 2 * float(np.spacing(np.abs(frames).max()))
            codec = float(np.abs(decoded - frames).max())
            fit = float(np.abs(npz - superpose_center(frames[:, heavy].copy())).max())
            worst[fmt] = [max(worst[fmt][0], codec), max(worst[fmt][1], fit), bound]
            check(npz.shape == (PEP_S2_FRAMES, len(heavy), 3) and len(heavy) < frames.shape[1],
                  f"trajio {name}: npz {npz.shape}, {len(heavy)} of {frames.shape[1]} heavy")
            check(len(atom_names) == len(heavy) == sum(len(a) for _, a in residues)
                  and len(residues) == 4
                  and not any(a.startswith("H") or a[:1].isdigit() for a in atom_names),
                  f"trajio {name}: state0 holds {atom_names}")
            check(codec <= bound, f"trajio {name} ({fmt}): codec error {codec} > {bound}")
            check(np.array_equal(npz, superpose_center(decoded[:, heavy])),
                  f"trajio {name}: the npz is not the decoded frames after superpose_center")
            check(fit <= TRAJIO_FIT_FACTOR * bound,
                  f"trajio {name} ({fmt}): npz vs written frames {fit} > "
                  f"{TRAJIO_FIT_FACTOR} x {bound}")
        for fmt, (codec, fit, bound) in worst.items():
            print(f"trajio {fmt}: decoded vs written max {codec:.3e} nm (bound {bound:.3e}); "
                  f"npz vs written after superpose_center max {fit:.3e} nm (tol "
                  f"{TRAJIO_FIT_FACTOR * bound:.3e})")
        print(f"trajio: {len(written)} raw peptides x {PEP_S2_FRAMES} frames written in "
              f"{t1 - t0:.2f} s, processed in {t2 - t1:.2f} s (hydrogens stripped, state0 "
              f"parsed)")

        # 3. the 4AA CLI on the processed files at full width
        common = ["--workspace", ws, "--data-root", root, "--epochs", "1", "--set",
                  "val_every_n_epochs=1"]
        reset_counts()
        t0 = time.perf_counter()
        rc1 = cli(["--experiment", "peptide_first_stage", "--run-id", "t1",
                   "--exp-set", f"repeats={PEP_S1_REPEATS}", *common])
        torch.cuda.synchronize()
        s1_counts = read_counts()
        t1 = time.perf_counter()
        reset_counts()
        rc2 = cli(["--experiment", "peptide_second_stage", "--run-id", "t2",
                   "--first-stage-run", "t1", "--set", "limit_val_batches=1",
                   "--exp-set", f"repeats={PEP_S2_REPEATS}", *common])
        torch.cuda.synchronize()
        s2_counts = read_counts()
        t2 = time.perf_counter()
        print(f"trajio: stage 1 {t1 - t0:.2f} s, stage 2 {t2 - t1:.2f} s (datasets from the "
              f"processed files, steps, val, checkpoints); return codes {rc1} {rc2}")
        check((rc1, rc2) == (0, 0), f"trajio: CLI return codes {rc1} {rc2}")
        with open(f"{ws}/runs.json") as f:
            runs = json.load(f)
        check(runs["t2"]["config"]["launch"]["data_root"] == root
              and runs["t2"]["config"]["first_stage_run"] == "t1",
              "trajio: runs.json does not record the data root or the stage-1 run")
        for run_id, want_steps in (("t1", 3), ("t2", 3)):
            with open(f"{ws}/{run_id}/metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            check([r["split"] for r in records] == ["train", "val/val"],
                  f"trajio {run_id} metrics.jsonl splits {[r['split'] for r in records]}")
            check(all(math.isfinite(v) for r in records for v in r.values()
                      if isinstance(v, float)), f"trajio {run_id}: a non-finite metric")
            train = records[0]
            print(f"timing trajio {run_id}: {train['time_s']} s an epoch, step_ms "
                  f"{train['step_ms']} (the epoch over its steps, set-up included) | {smi}")
            print(f"trajio {run_id} records: {records}")
        bf16 = {k: s2_counts[k] - s2_counts.get(f"{k} fp32", 0) for k in ("K1", "K2", "K7", "K8")}
        print(f"trajio: stage-1 launches {s1_counts}; stage-2 launches {s2_counts}")
        check(all(v > 0 for v in bf16.values()) and s2_counts["K4 sm90"] > 0
              and s2_counts["K8 fp32"] == 0,
              f"trajio: a bf16 kernel or K4 did not launch in stage 2: {s2_counts}")
        torch.cuda.empty_cache()

        # 4. the loaders' host batch, engine against numpy
        host_batch_times(dev, smi)

        # 5. one smoke sweep through run_sweep, in-process on the card
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            run_ids = sweeps.run_sweep("peptide", workspace=f"{ws}/sweep", smoke=True)
        check(len(run_ids) == len(sweeps.SWEEPS["peptide"]), f"trajio sweep: {run_ids}")
        with open(f"{ws}/sweep/{run_ids[0]}/metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        check(records and all(math.isfinite(v) for r in records for v in r.values()
                              if isinstance(v, float)), "trajio sweep: a non-finite metric")
        print(f"trajio: sweep peptide --smoke (peptide_second_stage) run {run_ids[0]} in "
              f"{time.perf_counter() - t0:.2f} s, {len(records)} records, last {records[-1]}")
    finally:
        if saved_env is None:
            os.environ.pop("LAM_SLIDE_NO_DATA_CACHE", None)
        else:
            os.environ["LAM_SLIDE_NO_DATA_CACHE"] = saved_env
        shutil.rmtree(ws, ignore_errors=True)


def _whole_params(model) -> dict:
    """The whole parameters of a model, fp32, under the one-rank names: an
    FSDP2 model's DTensors and a tensor-parallel model's shards gathered."""
    from lam_slide_tpu_torch.parallel import gather_tree
    from lam_slide_tpu_torch.parallel.fsdp import full, reshard, uses_fsdp

    if uses_fsdp(model):
        reshard(model)
    params = {k: full(p).detach().float().clone() for k, p in model.named_parameters()}
    return gather_tree(model, params)


def _moved_err(params, start, ref_params) -> tuple:
    """(worst ||p - p_ref|| / ||p_ref - p0|| over the tensors, its name)."""
    worst = (0.0, "")
    for name, p in params.items():
        moved = (ref_params[name] - start[name]).norm().item()
        if moved:
            worst = max(worst, ((p - ref_params[name]).norm().item() / moved, name))
    return worst


def parallel_phase(dev, smi, make_model, pep_state, reset_counts, read_counts):
    """Phase 19: the data-parallel and FSDP2 steps on an NCCL group of one
    rank, the ring of P chunks on the card, the peptide sampling hook."""
    import tempfile

    import torch.distributed as dist

    from lam_slide_tpu_torch import parallel
    from lam_slide_tpu_torch.analysis.callbacks import make_peptide_sampling_hook
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.parallel import rows as prow
    from lam_slide_tpu_torch.train import create_train_state
    from lam_slide_tpu_torch.train import steps as tsteps

    # what the wrapped steps run of the data-parallel path: the grad
    # all-reduces, and the rows each random draw was made for
    seen = {"reduces": 0, "draws": []}
    real_reduce, real_draw = tsteps.all_reduce_mean, prow._draw

    def counted_reduce(tensors, group):
        seen["reduces"] += 1
        return real_reduce(tensors, group)

    def recorded_draw(*args, **kwargs):
        seen["draws"].append(prow.active())
        return real_draw(*args, **kwargs)

    with tempfile.TemporaryDirectory(prefix="parallel_") as tmp:
        parallel.init_distributed("nccl", rank=0, world_size=1,
                                  init_method=f"file://{tmp}/rendezvous")
        tsteps.all_reduce_mean, prow._draw = counted_reduce, recorded_draw
        try:
            mesh = parallel.make_mesh(parallel.MeshSpec())
            print(f"parallel: NCCL group of {dist.get_world_size()}, mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}")
            # (i) the wrapped train steps against the unwrapped one
            for heads in (HEADS, WIDE_HEADS):
                split = f"{heads}x{HIDDEN // heads}"
                results = {}
                for mode in ("plain", "repeat", "dp", "fsdp"):
                    wrapped = mode in ("dp", "fsdp")
                    state, step, transport = train_state(make_model, heads,
                                                         mesh=mesh if wrapped else None)
                    if mode == "plain":
                        start = {k: v.detach().float().clone()
                                 for k, v in state.model.named_parameters()}
                    batch = train_batch(TRAIN_BATCH, dev, transport, False, SEED)
                    if mode == "fsdp":
                        state = parallel.shard_train_state_fsdp(state, mesh)
                        share = parallel.sharded_share(state.model, 1)
                        print(f"parallel {split} fsdp: {share['sharded_bytes']}/"
                              f"{share['total_bytes']} parameter bytes in DTensor shards "
                              f"over data (one rank)")
                    if wrapped:
                        batch = parallel.shard_batch(batch, mesh, full_local=True)
                    torch.cuda.synchronize()
                    reset_counts()
                    seen["reduces"], seen["draws"] = 0, []
                    t0 = time.perf_counter()
                    state, metrics = step(state, batch, SEED)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    counts = read_counts()
                    loss = metrics["loss"].item()
                    ran = (seen["reduces"], len(seen["draws"]),
                           sum(r is not None and r.group is not None for r in seen["draws"]))
                    if mode == "plain":
                        ref = {k: v.detach().float().clone()
                               for k, v in state.model.named_parameters()}
                        results[mode] = (loss, (0.0, ""), counts, secs, ran)
                    else:
                        results[mode] = (loss, _moved_err(_whole_params(state.model), start, ref),
                                         counts, secs, ran)
                    del state, step
                    torch.cuda.empty_cache()
                ref_loss, _, ref_counts, _, _ = results["plain"]
                for mode, (loss, (moved, where), counts, secs, ran) in results.items():
                    rel = abs(loss - ref_loss) / abs(ref_loss)
                    reduces, draws, row_draws = ran
                    print(f"parallel {split} B={TRAIN_BATCH} {mode} step: loss {loss:.6f} (rel "
                          f"err {rel:.3e}, tol {PAR_LOSS_REL_TOL}); worst parameter move err "
                          f"{moved:.3e} at {where or '-'} (tol {PAR_MOVED_REL_TOL}); "
                          f"{secs * 1e3:.1f} ms (first step of its state); grad all-reduces "
                          f"{reduces}, draws {draws} ({row_draws} for a LocalBatch's rows over "
                          f"the group); launches {counts} | {smi}")
                    check(rel <= PAR_LOSS_REL_TOL, f"parallel {split} {mode}: loss {loss} vs "
                          f"{ref_loss}")
                    # the DP step all-reduces its grads once; FSDP2 reduce-scatters
                    # them itself; both draw every t/x0/dropout for their rows
                    check(reduces == (1 if mode == "dp" else 0),
                          f"parallel {split} {mode}: {reduces} grad all-reduces")
                    check(draws > 0 and row_draws == (draws if mode in ("dp", "fsdp") else 0),
                          f"parallel {split} {mode}: {row_draws} of {draws} draws for rows")
                    check(moved <= PAR_MOVED_REL_TOL, f"parallel {split} {mode}: {where} moved "
                          f"{moved} off the unwrapped step")
                    check(counts == ref_counts, f"parallel {split} {mode}: launches {counts} != "
                          f"{ref_counts}")

            # (ii) the ring of P chunks against one K1 + K4 call
            p = PAR_RING_CHUNKS
            for shape in PAR_RING_SHAPES:
                gen = torch.Generator(device=dev).manual_seed(SEED + 19)
                q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                              for _ in range(4))

                def ring():
                    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
                    out = torch.cat(parallel.ring_attention_chunks(
                        qs.chunk(p, 2), ks.chunk(p, 2), vs.chunk(p, 2)), 2)
                    return (out.detach(), *torch.autograd.grad(out, (qs, ks, vs), g))

                def whole():
                    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
                    out = fa.flash_attention(qs, ks, vs)
                    return (out.detach(), *torch.autograd.grad(out, (qs, ks, vs), g))

                reset_counts()
                got = ring()
                torch.cuda.synchronize()
                counts = read_counts()
                want = whole()
                errs = [((a.float() - b.float()).norm() / b.float().norm()).item()
                        for a, b in zip(got, want)]
                ring_ms, whole_ms = time_ms(ring, reps=5), time_ms(whole, reps=5)
                print(f"parallel ring P={p} {list(shape)} bf16, forward + grads vs one K1 + K4 "
                      f"call: rel err out/dq/dk/dv {[f'{e:.3e}' for e in errs]} (tol "
                      f"{PAR_RING_REL_TOL}); launches K1 {counts['K1']} K4 {counts['K4 kv']} "
                      f"(K4 sm90 kernels {counts['K4 sm90']}); ring {ring_ms:.3f} ms, one "
                      f"K1 + K4 {whole_ms:.3f} ms | {smi}")
                check(max(errs) <= PAR_RING_REL_TOL, f"ring {shape}: rel errs {errs}")
                check(counts["K1"] == p * p and counts["K4 kv"] == p * p,
                      f"ring {shape}: K1 {counts['K1']} K4 {counts['K4 kv']} != {p * p}")
        finally:
            tsteps.all_reduce_mean, prow._draw = real_reduce, real_draw
            dist.destroy_process_group()

    # (iii) the peptide sampling hook on phase 15's trained stage-2 run
    exp, raw = pep_state
    state = create_train_state(exp.model, exp.tx)
    exp.model.load_state_dict(raw["params"])
    for name, e in state.ema_params.items():
        e.copy_(raw["ema_params"][name])
    trajectories = exp.val_loaders["val"].dataset.trajectories
    with tempfile.TemporaryDirectory(prefix="hook_") as run_dir:
        hook = make_peptide_sampling_hook(exp.second_stage, trajectories, run_dir,
                                          figures=False)
        reset_counts()
        # the hook reports a peptide it could not sample and goes on (as in
        # training); here every peptide must be sampled
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            summary = hook(state, 0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = read_counts()
    said = said.getvalue()
    print(said, end="")
    n_pep = min(2, len(trajectories))
    print(f"parallel: peptide sampling hook (Euler-10, 2 rollouts x {n_pep} val peptides, EMA "
          f"weights) in {secs:.2f} s: {summary}; launches {counts} | {smi}")
    check(n_pep > 0 and "sampling hook failed" not in said,
          f"sampling hook left out a peptide: {said.strip()!r}")
    check(summary is not None and all(math.isfinite(v) for v in summary.values()),
          f"sampling hook summary {summary}")
    check(counts["K8"] > 0 and counts["K2"] > 0, f"sampling hook launches {counts}")


def _tp_grads(model, loss_fn, batch) -> dict:
    """The whole (gathered) grads of one backward of ``loss_fn`` on ``batch``."""
    from lam_slide_tpu_torch.parallel import gather_tree

    loss_fn(model, batch, torch.Generator(device=batch["x1" if "x1" in batch else "pos"].device)
            .manual_seed(SEED + 1), True)[0].backward()
    grads = {k: p.grad.detach().float().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return gather_tree(model, grads)


def _tp_grad_errors(got, want) -> tuple:
    """(global norm rel err, worst per-tensor ||g - g_ref|| / ||g_ref||, its name)."""
    norm_err = abs(_global_norm(got) - _global_norm(want)) / _global_norm(want)
    worst = max((((got[k] - w).norm() / w.norm()).item(), k) for k, w in want.items()
                if w.norm() > 0)
    return norm_err, *worst


def _tp_step(state, step, batch, reset_counts, read_counts):
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, SEED)
    loss = metrics["loss"].item()
    secs = time.perf_counter() - t0
    return state, loss, read_counts(), secs


def _tp_want(ref_counts, size, fp32):
    """The launches of a step with every block in ``size`` shards, from the
    unsharded step's: every kernel of a block once a shard, K7 once a layer;
    K8 only as its partial instance, on the route of the rank's widths (the
    WMMA route at 16 x 24 tp 8 in bf16, whose Hopper plan needs Da a whole
    number of head groups of 96); K2-fp32's two routes taken together (its
    outer-product instance needs d_mid a multiple of its chunk: 3 x 128 tp 3's
    256 takes the dot-product kernel)."""
    want = {k: v if k.startswith("K7") else v * size for k, v in ref_counts.items()}
    want["K8 tp partial"] = ref_counts["K8"] * size if size > 1 else 0
    if not fp32 and size == TP_WMMA_SPLIT[1]:
        want["K8 wmma"] = ref_counts["K8"] * size
    if fp32:
        for key in ("K2 fp32 tiled", "K2 fp32 dot"):
            want.pop(key)
    return want


def _tp_counts_ok(counts, want) -> bool:
    return ({k: counts[k] for k in want} == want
            and counts["K2 fp32 tiled"] + counts["K2 fp32 dot"] == want["K2 fp32"])


def tp_phase(dev, smi, make_model, md17_run, md17_f32_run, reset_counts, read_counts) -> dict:
    """Phase 20: tensor parallelism (parallel/tp.py) with every shard of a
    block in this process on the one card (a card hosts one NCCL rank):
    the 4AA stage-2 B=16 train step in bf16 at each split of TP_SPLITS and
    at 16 x 24 tp 8 (K8 on the WMMA partial), and in fp32 (TF32 off) at
    each split of TP_SPLITS (K8-fp32's outer-product partial); the MD17
    stage-2 B=64 step at tp TP_MD17 in bf16 (phase 10's run) and in fp32
    (phase 16's 16 x 16 run); each against the unsharded step of its dtype
    on the same weights and draws (the loss, the grads, the parameter
    moves, beside the unsharded step's own repeat) with its launches. Then
    an Euler-10 B=8 solve through the shards at 16 x 24 tp 2 against the
    unsharded solve, and a forward of a DiT of the NBA widths at tp 8 in
    bf16 (the WMMA partial) and fp32 (the dot-product partial) against the
    unsharded forward. Every kernel of a block runs once a shard (K8 as the
    partial instance, K2 at d_mid = M/tp, K1/K3, K5, K4, K6, K9 on the
    shard's heads), K7 once a layer. Returns the main-path launches of the
    summary's partial rows: K8's Hopper and fp32 outer-product partials
    from the 16 x 24 tp 2 steps, its WMMA partial from the tp 8 step, its
    fp32 dot-product partial from the NBA fp32 forward."""
    import copy

    from lam_slide_tpu_torch.models import LatentDiT
    from lam_slide_tpu_torch.parallel import tp
    from lam_slide_tpu_torch.train import create_train_state, make_train_step
    from lam_slide_tpu_torch.transport import Sampler, create_transport

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    main_counts = {}
    for fp32 in (False, True):
        dtype = torch.float32 if fp32 else torch.bfloat16
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
            (False, False) if fp32 else saved)
        name = "fp32" if fp32 else "bf16"
        loss_tol = TP_F32_LOSS_REL_TOL if fp32 else TP_LOSS_REL_TOL
        grad_tols = F32_TRAIN_GRAD_REL_TOL if fp32 else (GRAD_NORM_REL_TOL["bf16"],
                                                          GRAD_TENSOR_REL_TOL["bf16"])
        moved_tol = TP_F32_MOVED_REL_TOL if fp32 else TP_MOVED_REL_TOL
        splits = TP_SPLITS if fp32 else TP_SPLITS + (TP_WMMA_SPLIT,)
        for heads in (HEADS, WIDE_HEADS):
            split = f"{heads}x{HIDDEN // heads}"
            results = {}
            for mode in ("plain", "repeat", *(f"tp{s}" for h, s in splits if h == heads)):
                state, step, transport = train_state(make_model, heads, dtype=dtype)
                if mode == "plain":
                    start = _whole_params(state.model)
                batch = train_batch(TRAIN_BATCH, dev, transport, False, SEED)
                size = int(mode[2:]) if mode.startswith("tp") else 1
                if size > 1:
                    state = tp.shard_train_state(state, size=size)
                grads = _tp_grads(state.model, si_loss_fn(transport),
                                  train_batch(GRAD_BATCH, dev, transport, True, SEED + 1))
                state, loss, counts, secs = _tp_step(state, step, batch, reset_counts,
                                                     read_counts)
                params = _whole_params(state.model)
                if mode == "plain":
                    ref, ref_grads = params, grads
                results[mode] = (size, loss, _moved_err(params, start, ref),
                                 _tp_grad_errors(grads, ref_grads), counts, secs)
                del state, step, params, grads
                torch.cuda.empty_cache()
            _, ref_loss, _, _, ref_counts, ref_secs = results["plain"]
            for mode, (size, loss, (moved, where), gerr, counts, secs) in results.items():
                rel = abs(loss - ref_loss) / abs(ref_loss)
                want = _tp_want(ref_counts, size, fp32)
                cp_async = {k: v for k, v in counts.items() if "cp.async" in k}
                k8 = (f"K8 fp32 {counts['K8 fp32']} (outer-product {counts['K8 fp32 tiled']}, "
                      f"dot-product {counts['K8 fp32 dot']}), K2 fp32 {counts['K2 fp32']} "
                      f"(outer-product {counts['K2 fp32 tiled']}, dot-product "
                      f"{counts['K2 fp32 dot']})" if fp32 else
                      f"K8 {counts['K8']} (WMMA {counts['K8 wmma']}), K2 {counts['K2']}")
                print(f"tp {split} {name} B={TRAIN_BATCH} {mode} step: loss {loss:.6f} (rel err "
                      f"{rel:.3e}, tol {loss_tol}); grads at B={GRAD_BATCH} vs unsharded: norm "
                      f"rel err {gerr[0]:.3e} (tol {grad_tols[0]}), worst tensor {gerr[1]:.3e} "
                      f"at {gerr[2]} (tol {grad_tols[1]}); worst parameter move err "
                      f"{moved:.3e} at {where or '-'} (tol {moved_tol}); {secs * 1e3:.1f} ms "
                      f"(first step of its state; unsharded {ref_secs * 1e3:.1f} ms); launches "
                      f"{k8}, tp partial {counts['K8 tp partial']}, K1 {counts['K1']}, K5 "
                      f"{counts['K5']}, K4 {counts['K4 kv']}, K6 {counts['K6']}, K7 "
                      f"{counts['K7']}, cp.async {cp_async} | {smi}")
                check(rel <= loss_tol, f"tp {split} {name} {mode}: loss {loss} vs {ref_loss}")
                check(gerr[0] <= grad_tols[0] and gerr[1] <= grad_tols[1],
                      f"tp {split} {name} {mode}: grads vs unsharded {gerr}")
                check(moved <= moved_tol, f"tp {split} {name} {mode}: {where} moved {moved} off "
                      f"the unsharded step")
                check(_tp_counts_ok(counts, want),
                      f"tp {split} {name} {mode}: launches {counts} != {want}")
                check(not any(cp_async.values()),
                      f"tp {split} {name} {mode}: cp.async launches {cp_async}")
                if (heads, size) == (HEADS, 2):
                    key = "K8 fp32 tp partial" if fp32 else "K8 tp partial"
                    main_counts[key] = counts["K8 tp partial"]
                if (heads, size) == TP_WMMA_SPLIT and not fp32:
                    main_counts["K8 wmma tp partial"] = counts["K8 wmma"]

        # the MD17 stage-2 DiT (depth 4, hidden 256, 16 x dh 16; its spatial
        # axis L=192 on K3, its temporal axis T=30 on K9): phase 10's bf16
        # run, phase 16's fp32 one
        run2, batch2 = md17_f32_run if fp32 else md17_run
        base = copy.deepcopy(run2.model)
        results = {}
        for mode in ("plain", "repeat", f"tp{TP_MD17}"):
            model = copy.deepcopy(base)
            state = create_train_state(model, run2.tx)
            step = make_train_step(run2.loss_fn, run2.tx, ema_decay=run2.trainer_cfg.ema_decay)
            if mode == "plain":
                start = _whole_params(model)
            size = int(mode[2:]) if mode.startswith("tp") else 1
            if size > 1:
                state = tp.shard_train_state(state, size=size)
            grads = _tp_grads(state.model, run2.loss_fn,
                              {k: v[:GRAD_BATCH] for k, v in batch2.items()})
            state, loss, counts, secs = _tp_step(state, step, batch2, reset_counts, read_counts)
            params = _whole_params(state.model)
            if mode == "plain":
                ref, ref_grads = params, grads
            results[mode] = (size, loss, _moved_err(params, start, ref),
                             _tp_grad_errors(grads, ref_grads), counts, secs)
            del state, step, model, params, grads
            torch.cuda.empty_cache()
        grad_tols = F32_TRAIN_GRAD_REL_TOL if fp32 else MD17_GRAD_REL_TOL
        _, ref_loss, _, _, ref_counts, ref_secs = results["plain"]
        for mode, (size, loss, (moved, where), gerr, counts, secs) in results.items():
            rel = abs(loss - ref_loss) / abs(ref_loss)
            cp_async = {k: v for k, v in counts.items() if "cp.async" in k}
            print(f"tp md17 16x16 {name} B={MD17_BATCH} {mode} step: loss {loss:.6f} (rel err "
                  f"{rel:.3e}, tol {loss_tol}); grads at B={GRAD_BATCH} vs unsharded: norm rel "
                  f"err {gerr[0]:.3e} (tol {grad_tols[0]}), worst tensor {gerr[1]:.3e} at "
                  f"{gerr[2]} (tol {grad_tols[1]}); worst parameter move err {moved:.3e} at "
                  f"{where or '-'} (tol {moved_tol}); {secs * 1e3:.1f} ms (unsharded "
                  f"{ref_secs * 1e3:.1f} ms); launches K1 {counts['K1']} (fp32 "
                  f"{counts['K1 fp32']}), K2 {counts['K2']} (fp32 {counts['K2 fp32']}), K9 "
                  f"{counts['K9']} (fp32 {counts['K9 fp32']}), K9 bwd {counts['K9 bwd']} (fp32 "
                  f"{counts['K9 bwd fp32']}), K4 {counts['K4 kv']}, K7 {counts['K7']}, "
                  f"cp.async {cp_async} | {smi}")
            check(rel <= loss_tol, f"tp md17 {name} {mode}: loss {loss} vs {ref_loss}")
            check(gerr[0] <= grad_tols[0] and gerr[1] <= grad_tols[1],
                  f"tp md17 {name} {mode}: grads vs unsharded {gerr}")
            check(moved <= moved_tol, f"tp md17 {name} {mode}: {where} moved {moved}")
            # kernels of the DiT blocks alone, and in fp32 each on its fp32 kernel
            keys = ("K2", "K9", "K9 bwd") + (("K2 fp32", "K9 fp32", "K9 bwd fp32") if fp32
                                             else ())
            for key in keys:
                check(counts[key] == ref_counts[key] * size,
                      f"tp md17 {name} {mode}: {key} {counts[key]} != {size} x {ref_counts[key]}")
            check(not fp32 or counts["K9 fp32"] == counts["K9"] > 0,
                  f"tp md17 fp32 {mode}: a bf16 K9 launch {counts}")
            check(not any(cp_async.values()), f"tp md17 {name} {mode}: cp.async {cp_async}")
        del base, run2, batch2
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    # an Euler-10 solve through the sharded forward, against the unsharded
    euler = Sampler(create_transport(path_type="GVP", prediction="data")).sample_ode(
        sampling_method="euler", num_steps=NUM_STEPS)
    model = make_model(HEADS)
    noise, x_cond, mask = make_inputs(TP_SOLVE_BATCH, dev, torch.Generator().manual_seed(SEED + 20))
    kw = dict(x_cond=x_cond, x_cond_mask=mask)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = euler(noise, model, **kw)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        tp.shard_model(model, tp.in_process(2))
        reset_counts()
        t0 = time.perf_counter()
        got = euler(noise, model, **kw)
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t0
    counts = read_counts()
    _, rel = errors(got, want)
    evals = DEPTH * 2 * DRIFT_EVALS
    print(f"tp Euler-{NUM_STEPS} {HEADS}x{HIDDEN // HEADS} B={TP_SOLVE_BATCH} tp 2: out "
          f"{list(got.shape)} vs the unsharded solve rel err {rel:.3e} (tol {MODEL_REL_TOL}); "
          f"solve {tp_s:.3f} s (unsharded {whole_s:.3f} s, each its first); launches K8 "
          f"{counts['K8']} (tp partial {counts['K8 tp partial']}), K2 {counts['K2']}, K1 "
          f"{counts['K1']}, K7 {counts['K7']} | {smi}")
    check(bool(torch.isfinite(got).all()) and rel <= MODEL_REL_TOL,
          f"tp Euler solve rel err {rel}")
    check(counts["K8 tp partial"] == evals and counts["K2"] == evals and counts["K1"] == evals,
          f"tp Euler solve launches {counts}: not {evals} K8 partials, K2 and K1")
    del model
    torch.cuda.empty_cache()

    # one forward of a DiT of the NBA stage 2's widths (composites/nba.py:
    # depth 6, hidden 256, 16 x dh 16, mlp_ratio 2, T = 20, L = 8, B = 1024)
    # at tp 8, whose ranks (2 heads, Da 32) sit below the Hopper kernel's
    # head group of 64 and the outer-product kernel's: bf16 on the WMMA
    # partial, fp32 (TF32 off) on the dot-product partial
    b, d, heads, l, _ = PN_SHAPES["nba"]
    g = torch.Generator().manual_seed(SEED + 21)
    x = torch.randn(b, PN_T, l, 32, generator=g).to(dev)
    mask = torch.zeros(b, PN_T, l, dtype=torch.long, device=dev)
    mask[:, :8] = 1  # NBA's cond_idx (0, 8): eight frames condition
    tvec = torch.rand(b, generator=g).to(dev)
    for fp32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
            (False, False) if fp32 else saved)
        model = LatentDiT(depth=PN_DEPTH, in_dim=32, hidden_size=d, num_heads=heads, mlp_ratio=2,
                          reference_init=False, dtype=torch.float32 if fp32 else torch.bfloat16,
                          device=dev, generator=torch.Generator().manual_seed(SEED)).eval()
        with torch.no_grad():
            want = model(x, tvec, x * mask[..., None], mask)
            tp.shard_model(model, tp.in_process(TP_NBA))
            torch.cuda.synchronize()
            reset_counts()
            got = model(x, tvec, x * mask[..., None], mask)
            torch.cuda.synchronize()
        counts = read_counts()
        _, rel = errors(got, want)
        name, tol = ("fp32", TP_F32_FWD_REL_TOL) if fp32 else ("bf16", MODEL_REL_TOL)
        route = "K8 fp32 dot" if fp32 else "K8 wmma"
        print(f"tp nba {heads}x{d // heads} {name} forward B={b} T={PN_T} L={l} tp {TP_NBA}: out "
              f"{list(got.shape)} vs the unsharded forward rel err {rel:.3e} (tol {tol}); "
              f"launches K8 {counts['K8']} (tp partial {counts['K8 tp partial']}, WMMA "
              f"{counts['K8 wmma']}, fp32 outer-product {counts['K8 fp32 tiled']}, fp32 "
              f"dot-product {counts['K8 fp32 dot']}), K9 {counts['K9']}, K2 {counts['K2']}, K7 "
              f"{counts['K7']} | {smi}")
        layers = PN_DEPTH * TP_NBA
        check(bool(torch.isfinite(got).all()) and rel <= tol, f"tp nba {name}: rel err {rel}")
        check(counts["K8 tp partial"] == counts[route] == counts["K8"] == layers
              and counts["K9"] == counts["K2"] == layers, f"tp nba {name}: launches {counts}")
        if fp32:
            main_counts["K8 fp32 tp partial dot"] = counts["K8 fp32 dot"]
        del model, want, got
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return main_counts


def launch_counters() -> dict:
    """name -> (module, counter attribute) of every launch counter the
    phases read."""
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr
    from lam_slide_tpu_torch.ops import fused_adaln as fad
    from lam_slide_tpu_torch.ops import fused_mlp as fm
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
    from lam_slide_tpu_torch.ops import short_attention as tsa
    from lam_slide_tpu_torch.ops.ablations import fused_temporal_attention as tft
    from lam_slide_tpu_torch.ops.ablations import short_backward as tsb

    return {"K1": (fa, "launches"), "K1 bias": (fa, "bias_launches"),
                "K1 fp32": (fa, "fp32_launches"), "K2": (fm, "launches"),
                "K2 fp32": (fm, "fp32_launches"), "K7 fp32": (fad, "fp32_launches"),
                "K1 fp32 wide": (fa, "fp32_wide_launches"),
                "K5 fp32 wide": (fnr, "fp32_wide_launches"),
                "K1 fp32 narrow": (fa, "fp32_narrow_launches"),
                "K5 fp32 narrow": (fnr, "fp32_narrow_launches"),
                "K8 fp32 tiled": (fsb, "f32_tiled_launches"),
                "K8 fp32 dot": (fsb, "f32_dot_launches"),
                "K2 fp32 tiled": (fm, "fp32_tiled_launches"),
                "K2 fp32 dot": (fm, "fp32_dot_launches"),
                "K9 fp32": (tsa, "fp32_launches"),
                "K2 wmma": (fm, "wmma_launches"), "K2 cp.async": (fm, "cp_async_launches"),
                "K5": (fnr, "launches"), "K5 fp32": (fnr, "fp32_launches"),
                "K7": (fad, "launches"), "K8": (fsb, "launches"),
                "K8 wmma": (fsb, "wmma_launches"), "K8 fp32": (fsb, "f32_launches"),
                "K9": (tsa, "launches"), "K9 bwd": (tsa, "bwd_launches"),
                "K4 kv": (fa, "bwd_kv_launches"), "K4 q": (fa, "bwd_q_launches"),
                "K4 bias": (fa, "bwd_bias_launches"), "K4 fp32": (fa, "bwd_fp32_launches"),
                "K6": (fnr, "bwd_launches"),
                "K10": (tft, "launches"), "K11": (tsb, "launches"),
                "K1 sm90": (fa, "sm90_launches"), "K1 cp.async": (fa, "sm90_cp_async_launches"),
                "K4 sm90": (fa, "bwd_sm90_launches"),
                "K4 cp.async": (fa, "bwd_sm90_cp_async_launches"),
                "K5 transform": (fnr, "transform_launches"), "K5 sm90": (fnr, "sm90_launches"),
                "K5 cp.async": (fnr, "sm90_cp_async_launches"),
                "K6 sm90": (fnr, "bwd_sm90_launches"),
                "K6 cp.async": (fnr, "bwd_sm90_cp_async_launches"),
                "K4 fp32 wide": (fa, "bwd_fp32_wide_launches"),
                "K6 fp32": (fnr, "bwd_fp32_launches"),
                "K6 fp32 wide": (fnr, "bwd_fp32_wide_launches"),
                "K9 bwd fp32": (tsa, "bwd_fp32_launches"),
                "K8 tp partial": (fsb, "tp_partial_launches")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from lam_slide_tpu_torch import native
    from lam_slide_tpu_torch.models import LatentDiT
    from lam_slide_tpu_torch.ops import _build
    from lam_slide_tpu_torch.transport import Sampler, create_transport

    counters = launch_counters()

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {key: getattr(mod, attr) for key, (mod, attr) in counters.items()}

    phase_t0 = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t0
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0:.2f} s")
        phase_t0 = now

    # 1. device
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    phase_done("device")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load_library()
    print(f"build: {lib.relative_to(_build.BUILD_ROOT.parent.parent)} "
          f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    engine = native.build()
    native.lib()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    print(f"build: native engine {os.path.relpath(engine, _build.BUILD_ROOT.parent.parent)} "
          f"({gxx.splitlines()[0]}) in {time.perf_counter() - t0:.2f} s")
    phase_done("build")

    # 3. kernels vs plain at main-path shapes; the backward checks draw from
    # a generator of their own, so the sampling phases see the same noise
    # as before them
    gen = torch.Generator().manual_seed(SEED)
    table = KernelTable()
    kernel_checks(dev, gen, table)
    backward_checks(dev, torch.Generator().manual_seed(SEED + 1), table)
    md17_kernel_checks(dev, torch.Generator().manual_seed(SEED + 3), table)
    md17_dit_kernel_checks(dev, torch.Generator().manual_seed(SEED + 4), table)
    md17_train_kernel_checks(dev, torch.Generator().manual_seed(SEED + 5), table)
    md17_f32_kernel_checks(dev, table)
    k2_f32_route_checks(dev, table)
    peptide_f32_kernel_checks(dev, torch.Generator().manual_seed(SEED + 10), table)
    dh128_kernel_checks(dev, table)
    md17_wide_bf16_checks(dev, SEED + 11, table)
    f32_train_kernel_checks(dev, table)
    k9_f32_edge_checks(dev)
    ablation_kernel_checks(dev, torch.Generator().manual_seed(SEED + 9), table)
    ped_nba_kernel_checks(dev, table)
    phase_done("kernels")

    # 4. the slice
    def make_model(heads, dtype=torch.bfloat16, backend="auto"):
        model = LatentDiT(depth=DEPTH, in_dim=DIN, hidden_size=HIDDEN, num_heads=heads,
                          mlp_ratio=MLP_RATIO, reference_init=False, dtype=dtype,
                          backend=backend, device=dev,
                          generator=torch.Generator().manual_seed(SEED))
        return model.eval()

    models = {HEADS: make_model(HEADS), WIDE_HEADS: make_model(WIDE_HEADS)}
    transport = create_transport(path_type="GVP", prediction="data")
    euler = Sampler(transport).sample_ode(sampling_method="euler", num_steps=NUM_STEPS)
    dopri5 = Sampler(transport).sample_ode(sampling_method="dopri5", atol=1e-6, rtol=1e-3,
                                           return_stats=True)

    def expected(heads, evals):
        """Launches per solve: per layer one temporal attention (K5 at
        dh % 128 == 0, else K1 through K3's entry), one K2, two K7 and one K8,
        and one more K7 for the output AdaLN of each forward."""
        attn = "K5" if HIDDEN // heads % 128 == 0 else "K1"
        per_layer = {key: 0 for key in counters}
        per_layer.update({"K2": 1, "K7": 2, "K8": 1, attn: 1})
        return with_sm90({key: (DEPTH * n + (key == "K7")) * evals
                          for key, n in per_layer.items()})

    launches = {}
    inputs = {}
    with torch.no_grad():
        for heads, batch in ((HEADS, 2), (HEADS, 8), (WIDE_HEADS, 8)):
            model = models[heads]
            noise, x_cond, mask = make_inputs(batch, dev, gen)
            inputs.setdefault(batch, (noise, dict(x_cond=x_cond, x_cond_mask=mask)))
            reset_counts()
            out = euler(noise, model, x_cond=x_cond, x_cond_mask=mask)
            torch.cuda.synchronize()
            counts, want = read_counts(), expected(heads, DRIFT_EVALS)
            if batch == 8:
                launches[heads] = counts
            print(f"slice: Euler-{NUM_STEPS} GVP data solve {heads}x{HIDDEN // heads} B={batch}: "
                  f"out {list(out.shape)} {out.dtype} finite={bool(torch.isfinite(out).all())} "
                  f"launches {counts} (expected {want})")
            check(tuple(out.shape) == (batch, T, L, DIN), f"output shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "non-finite solve output")
            check(counts == want, f"launch counts {counts} != {want}")

        # one full-width forward per split, kernel path vs plain paths, same
        # weights and inputs: the model call of a drift evaluation at t=0.5
        noise, kw = inputs[2]
        tvec = torch.full((2,), 0.5, device=dev)
        for heads, model in models.items():
            got = model(noise, tvec, **kw)
            model.backend = "plain"
            want = model(noise, tvec, **kw)
            model.backend = "auto"
            ref32 = make_model(heads, torch.float32, "plain")
            ref32.load_state_dict(model.state_dict())
            want32 = ref32(noise, tvec, **kw)
            torch.cuda.synchronize()
            abs_err, rel_err = errors(got, want)
            abs32, rel32 = errors(got, want32)
            print(f"slice: one forward {heads}x{HIDDEN // heads} B=2 t=0.5, kernel vs plain bf16: "
                  f"max_abs_err {abs_err:.3e} rel {rel_err:.3e} (tol {MODEL_REL_TOL}); vs plain "
                  f"fp32: max_abs_err {abs32:.3e} rel {rel32:.3e} (tol {MODEL_FP32_REL_TOL}); "
                  f"max|out| {want.abs().max().item():.3f}")
            check(rel_err <= MODEL_REL_TOL, f"{heads} heads: kernel vs plain rel err {rel_err}")
            check(rel32 <= MODEL_FP32_REL_TOL, f"{heads} heads: kernel vs fp32 rel err {rel32}")
            del ref32

        # the eval protocol's sampler: one dopri5 solve at 16 x 24
        noise, kw = inputs[DOPRI5_BATCH]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, (n_iters, n_acc) = dopri5(noise, models[HEADS], **kw)
        torch.cuda.synchronize()
        dopri5_s = time.perf_counter() - t0
        counts, nfe = read_counts(), 1 + 6 * n_iters
        want = expected(HEADS, nfe)
        print(f"slice: dopri5 (atol 1e-6, rtol 1e-3) GVP data solve {HEADS}x{HIDDEN // HEADS} "
              f"B={DOPRI5_BATCH}: n_iters {n_iters} n_accepted {n_acc} NFE {nfe} solve "
              f"{dopri5_s:.3f} s finite={bool(torch.isfinite(out).all())} launches {counts} "
              f"(expected {want})")
        check(n_iters < DOPRI5_MAX_STEPS, f"dopri5 stopped at max_steps ({n_iters}) before t1")
        check(bool(torch.isfinite(out).all()), "non-finite dopri5 output")
        check(counts == want, f"dopri5 launch counts {counts} != {want}")
        phase_done("slice")

        # 5. timing: warm-up, then plain, kernel, kernel, plain per arm
        for heads, batch in ((HEADS, 2), (HEADS, 8), (WIDE_HEADS, 8)):
            model, (noise, kw) = models[heads], inputs[batch]

            def solve(x, **kwargs):
                return euler(x, model, **kwargs)

            times = {"auto": [], "plain": []}
            for backend in ("auto", "plain"):
                model.backend = backend
                solve(noise, **kw)
            for backend in ("plain", "auto", "auto", "plain"):
                model.backend = backend
                times[backend].append(solve_time_s(solve, noise, kw))
            model.backend = "auto"
            kern, plain = np.mean(times["auto"]), np.mean(times["plain"])
            print(f"timing {heads}x{HIDDEN // heads} B={batch}: solve kernel path "
                  f"{kern * 1e3:.3f} ms ({batch * DRIFT_EVALS / kern:.2f} traj-ODE steps/s), "
                  f"plain path {plain * 1e3:.3f} ms ({batch * DRIFT_EVALS / plain:.2f} traj-ODE "
                  f"steps/s); runs kernel {[round(t * 1e3, 3) for t in times['auto']]} "
                  f"plain {[round(t * 1e3, 3) for t in times['plain']]} ms | {smi}")
        print(f"timing dopri5 {HEADS}x{HIDDEN // HEADS} B={DOPRI5_BATCH}: {nfe} drift evals in "
              f"{dopri5_s:.3f} s, {nfe / dopri5_s:.2f} drift-evals/s "
              f"({DOPRI5_BATCH * nfe / dopri5_s:.2f} traj-drift-evals/s) | {smi}")
        phase_done("timing")

        # 6. profile
        for heads, batch, backends in ((HEADS, 2, ("auto", "plain")),
                                       (HEADS, 8, ("auto", "plain")),
                                       (WIDE_HEADS, 8, ("auto",))):
            model = models[heads]
            for backend in backends:
                model.backend = backend
                profile_run(lambda: euler(inputs[batch][0], model, **inputs[batch][1]),
                            f"{heads}x{HIDDEN // heads} backend={backend} B={batch} Euler-10 solve")
            model.backend = "auto"
        phase_done("profile")

    # 7. train
    del models
    train_counts = train_checks(dev, make_model, reset_counts, read_counts)
    phase_done("train")

    # 8. train timing and profile
    train_timing(dev, make_model, smi)
    phase_done("train timing")

    # 9. the MD17 protocol
    md17_counts = md17_phase(dev, smi, reset_counts, read_counts)
    phase_done("md17")

    # 10. MD17 training, both stages
    s1_counts, s2_counts, md17_run = md17_train_phase(dev, smi, reset_counts, read_counts)
    phase_done("md17_train")

    # 11. the paths of K10 (the fused temporal block) and K11
    k10_counts, k11_counts = ablation_phase(dev, smi, reset_counts, read_counts)
    phase_done("ablation")

    # 12. the SDE sampler and the likelihood solve on the 4AA DiT
    sampler_phase(dev, make_model, smi, reset_counts, read_counts)
    phase_done("samplers")

    # 13. the linear-attention, shared-weight and tiny-width DiTs
    tiny_counts = dit_variants_phase(dev, reset_counts, read_counts)
    phase_done("dit_variants")

    # 14. MD17 through the port's own loop: CLI, Trainer, checkpoints, run
    # registry, the fp32 --test pass and --test-only
    _, loop_test_counts, _ = md17_loop_phase(dev, smi, reset_counts, read_counts)
    phase_done("md17_loop")

    # 15. the 4AA workload through the port's entry points: train.cli stage 1
    # and stage 2, then analysis.eval_cli (the fp32 DiT, dopri5, the JSD)
    peptide_eval_counts, wide_eval_counts, pep_state = peptide_loop_phase(
        dev, smi, reset_counts, read_counts)
    phase_done("peptide_loop")

    # 16. fp32 training: both registries' --smoke stage 2 through the CLI,
    # and the full-width fp32 stage-2 steps at all four head splits
    f32_counts, md17_f32_run = fp32_train_phase(dev, smi, reset_counts, read_counts)
    phase_done("fp32_train")

    # 17. the pedestrian and NBA workloads through train.cli: stage 1, stage
    # 2 and the fp32 --test pass (min over K, NBA's final-position
    # clustering), at full width
    ped_nba_loop_phase(dev, smi, reset_counts, read_counts)
    phase_done("ped_nba_loop")

    # 18. raw MD files through process_4aa into the 4AA CLI, the loaders'
    # host batch on the native engine and on numpy, one smoke sweep
    trajio_phase(dev, smi, reset_counts, read_counts)
    phase_done("trajio")

    # 19. parallel/: the DP and FSDP2 steps on a one-rank NCCL group, the
    # ring of P chunks on the card, the peptide sampling hook
    parallel_phase(dev, smi, make_model, pep_state, reset_counts, read_counts)
    del pep_state
    phase_done("parallel")

    # 20. tensor parallelism: the 4AA and MD17 stage-2 steps in bf16 and
    # fp32 with every shard of a block on the one card, an Euler solve
    # through the shards, the NBA-width forward at tp 8
    tp_counts = tp_phase(dev, smi, make_model, md17_run, md17_f32_run, reset_counts, read_counts)
    del md17_run, md17_f32_run
    phase_done("tp")

    sources = {
        "K1": ("flash_attention_fwd", "flash_fwd_sm90.cu", "flash_attention.py:37"),
        "K2": ("fused_mlp", "fused_mlp.cu", "fused_mlp.py:68"),
        "K3": ("flash_attention_packed", "flash_fwd_sm90.cu", "flash_attention.py:228"),
        "K5": ("flash_attention_normrope", "flash_fwd_sm90.cu", "flash_normrope.py:74"),
        "K5 transform": ("qk_normrope", "qk_normrope.cu", "flash_normrope.py:74"),
        "K7": ("residual_adaln_modulate", "fused_adaln.cu", "fused_adaln.py:98"),
        "K8": ("fused_spatial_block", "fused_spatial_block_sm90.cu",
               "fused_spatial_block.py:108"),
        "K8 wmma": ("fused_spatial_block (WMMA route, widths without a Hopper instance)",
                    "fused_spatial_block.cu", "fused_spatial_block.py:108"),
        "K4": ("flash_attention_backward", "flash_bwd_sm90.cu", "flash_attention.py:442"),
        "K6": ("flash_attention_normrope_backward", "flash_bwd_sm90.cu",
               "flash_normrope.py:249"),
        "K1 bias": ("flash_attention_fwd (key-padding bias, fp32: the narrow kernel over "
                    "32-key tiles)", "flash_attention.cu", "flash_attention.py:37"),
        "K1 fp32": ("flash_attention_fwd (fp32 operands at dh <= 64: the narrow register-tiled "
                    "kernel, also K3-fp32's on the fp32 DiTs)", "flash_attention.cu",
                    "flash_attention.py:37"),
        "K9": ("short_attention", "short_attention.cu", "short_attention.py:83"),
        "K4 bias": ("flash_attention_backward (key-padding bias, fp32)",
                    "flash_attention_bwd.cu", "flash_attention.py:442"),
        "K4 fp32": ("flash_attention_backward (fp32 operands)", "flash_attention_bwd.cu",
                    "flash_attention.py:442"),
        "K9 bwd": ("short_attention_backward", "short_attention.cu", "short_attention.py:96"),
        "K10": ("fused_temporal_attention", "flash_attention.cu",
                "ablations/fused_temporal_attention.py:75"),
        "K11": ("flash_backward_short", "short_backward.cu", "ablations/short_backward.py:31"),
        "K2 fp32": ("fused_mlp (fp32 operands)", "fused_mlp_f32.cu", "fused_mlp.py:68"),
        "K7 fp32": ("residual_adaln_modulate (fp32 operands)", "fused_adaln_f32.cu",
                    "fused_adaln.py:98"),
        "K9 fp32": ("short_attention (fp32 operands, forward)", "short_attention_f32.cu",
                    "short_attention.py:83"),
        "K8 fp32": ("fused_spatial_block (fp32 operands: the outer-product kernel at the 4AA, "
                    "NBA and pedestrian widths; under autograd the kernel's forward and the "
                    "plain VJP)",
                    "fused_spatial_block_f32.cu", "fused_spatial_block.py:108"),
        "K5 fp32": ("flash_attention_normrope (fp32 operands, forward: the fp32 transform, "
                    "then K1's fp32 kernel at 64 < dh <= 128)", "flash_attention.cu",
                    "flash_normrope.py:74"),
        "K5 transform fp32": ("qk_normrope (fp32 operands)", "qk_normrope.cu",
                              "flash_normrope.py:52"),
        "K1 fp32 dh128": ("flash_attention_fwd (fp32 operands at 64 < dh <= 128: the "
                          "register-tiled kernel, under K5-fp32 on the main paths)",
                          "flash_attention.cu", "flash_attention.py:37"),
        "K9 fp32 bwd": ("short_attention_backward (fp32 operands)", "short_attention_f32.cu",
                        "short_attention.py:96"),
        "K4 fp32 dh128": ("flash_attention_backward (fp32 operands at 64 < dh <= 128: the "
                          "wide kernel, one pass over the key tiles, and its dQ shares' sum; "
                          "under K6-fp32 on the main paths)",
                          "flash_attention_bwd.cu", "flash_attention.py:442"),
        "K6 fp32": ("flash_attention_normrope_backward (fp32 operands: K4-fp32's "
                    "wide kernel on the forward's q_t/k_t)", "flash_attention_bwd.cu",
                    "flash_normrope.py:249"),
        "K8 tp partial": ("fused_spatial_block (a tensor-parallel rank's fp32 partial: H/tp "
                          "heads, M/tp MLP columns, no b2)", "fused_spatial_block_sm90.cu",
                          "fused_spatial_block.py:108"),
        "K8 wmma tp partial": ("fused_spatial_block (a bf16 tensor-parallel rank's fp32 "
                               "partial below a Hopper head group: the WMMA route)",
                               "fused_spatial_block.cu", "fused_spatial_block.py:108"),
        "K8 fp32 tp partial": ("fused_spatial_block (an fp32 tensor-parallel rank's partial: "
                               "the outer-product kernel)", "fused_spatial_block_f32.cu",
                               "fused_spatial_block.py:108"),
        "K8 fp32 tp partial dot": ("fused_spatial_block (an fp32 tensor-parallel rank's partial "
                                   "below an outer-product instance's head group: the "
                                   "dot-product kernel)", "fused_spatial_block_f32.cu",
                                   "fused_spatial_block.py:108"),
    }
    # launches on the main paths: K1/K2/K7/K8 from the 16 x 24 B=8 Euler solve
    # (K1 and K3 one binary, flash_fwd_sm90.cu, whose launches it counts), K5
    # (its launches of flash_fwd_sm90.cu) and its transform kernel from the
    # 3 x 128 B=8 solve; K4 (the three kernels of flash_bwd_sm90.cu) from one
    # train step at 16 x 24, K6 (the same three kernels) at 3 x 128;
    # K1's bias and fp32 variants and K9 from one MD17 protocol batch; K4's
    # bias and fp32 variants and K9's backward from one MD17 train step of
    # each stage; K10 from one forward + backward of the fused temporal
    # block, K11 from its call at the MD17 spatial axis; K8's WMMA route
    # from the forward of the hidden-32 DiT (0 on every path above); K2, K7
    # and K9 in fp32 from phase 14's stage-2 run (its --test pass); K8 in
    # fp32 from phase 15's eval (two dopri5 windows of the fp32 DiT); K5 in
    # fp32, its fp32 transform and K1's register-tiled fp32 kernel under it
    # from phase 15's eval at 3 x 128; K8's tensor-parallel partial from
    # phase 20's 16 x 24 step at tp 2, its fp32 outer-product partial from
    # the fp32 16 x 24 step at tp 2, its WMMA partial from the bf16 16 x 24
    # step at tp 8 and its fp32 dot-product partial from the NBA-width fp32
    # forward at tp 8
    md17_train = {key: s1_counts[key] + s2_counts[key] for key in s1_counts}
    main_counts = dict(launches[HEADS], K1=launches[HEADS]["K1 sm90"],
                       K3=launches[HEADS]["K1 sm90"], K5=launches[WIDE_HEADS]["K5 sm90"],
                       K4=train_counts[HEADS]["K4 sm90"], K6=train_counts[WIDE_HEADS]["K6 sm90"],
                       **{"K5 transform": launches[WIDE_HEADS]["K5 transform"],
                          "K1 bias": md17_counts["K1 bias"],
                          "K1 fp32": md17_counts["K1 fp32 narrow"],
                          "K9": md17_counts["K9"], "K4 bias": md17_train["K4 bias"],
                          "K4 fp32": md17_train["K4 fp32"], "K9 bwd": md17_train["K9 bwd"],
                          "K10": k10_counts["K10"], "K11": k11_counts["K11"],
                          "K8 wmma": tiny_counts["K8 wmma"],
                          **{key: loop_test_counts[key]
                             for key in ("K2 fp32", "K7 fp32", "K9 fp32")},
                          "K8 fp32": peptide_eval_counts["K8 fp32 tiled"],
                          "K5 fp32": wide_eval_counts["K5 fp32"],
                          "K1 fp32 dh128": (wide_eval_counts["K5 fp32 wide"]
                                            + wide_eval_counts["K1 fp32 wide"]),
                          "K5 transform fp32": wide_eval_counts["K5 transform"],
                          "K9 fp32 bwd": f32_counts["md17 16x16"]["K9 bwd fp32"],
                          "K4 fp32 dh128": (f32_counts["4AA 3x128"]["K6 fp32 wide"]
                                            + f32_counts["4AA 3x128"]["K4 fp32 wide"]),
                          "K6 fp32": f32_counts["4AA 3x128"]["K6"],
                          **tp_counts})
    idle = [key for key in sources if not main_counts[key] > 0]
    check(not idle, f"kernels launched no time on their main paths: {idle}")
    kernels = [
        {"name": name, "route": "cuda", "source": f"lam_slide_tpu_torch/csrc/{src}",
         "replaces": f"lam_slide_tpu/ops/{tpu}", "launches": main_counts[key],
         **table.rows[key]}
        for key, (name, src, tpu) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
