"""The port's parallel/ against the JAX package's, on the CPU.

The multi-rank cases run once, in a module fixture: two gloo ranks spawned
by ``parallel.run_ranks`` (a dead or hung rank fails the fixture within its
wall limit) run ``tests/support_torch_parallel_ranks.parallel_checks`` and
return their results; JAX runs its side here, on its 8 virtual CPU devices.

* ``MeshSpec.shape`` and ``fsdp_spec`` against JAX's on the same shapes;
* ``Loader(process_shard=...)`` against JAX's, bit for bit, for 2
  processes, their concatenation the one-process batch; the fallbacks and
  errors;
* one data-parallel (DP) step and one FSDP2 step of the JAX multichip dry
  run's tiny MD17 second stage on 2 ranks, from the JAX init's converted
  weights, on a batch whose halves are ethanol and toluene (the ranks'
  masks differ): against the port's one-rank step and JAX's single-device
  ``make_train_step``, fed JAX's t and x0, and against the one-rank step
  on the port's own draws (each rank draws the global batch's and keeps
  its rows). The loss within LOSS_RTOL (1e-5 relative, fp32), the updated
  parameters and EMA against one rank within GRAD_TOL (1e-4) of each
  tensor's largest element, the tolerance tests/test_torch_port_md17_train.py
  holds grads to (2 ranks differ from 1 only by the all-reduce's order), and
  what the update moved against JAX within MOVED_TOL (1e-2) of its norm, as
  that file holds a step;
* the same loss from per-rank masked means would be wrong: the check has
  teeth;
* FSDP2's sharded share above 0.5, and JAX's rule's share (163,840 of
  241,184 bytes, MULTICHIP_r05.json) from the port's copy of the rule;
* the K8-fp32 weight-cache trap: operands kept across a version-preserving
  write are stale unless dropped, and under ``shard_model`` every forward
  after a step reads fresh ones;
* ``ring_attention`` in fp32 and bf16, on 2 ranks and as an 8-chunk ring in
  one process, forward and grads against JAX's ``sequence_parallel_attention``
  on its 8-device mesh and against ``reference_attention`` (JAX
  tests/test_ring_attention.py's tolerances);
* a sharded K=2 Euler-10 sample, each rank its rows with its rows of the
  injected noise, gathered, against the one-rank sample;
* grad_accum=2 on 2 ranks against the one-rank accumulating step over the
  same microbatches, with one grad all-reduce a step (none under FSDP2,
  whose reduce-scatter runs after the last microbatch alone);
* on a one-rank group, in this process, the DP and FSDP2 steps still run
  the data-parallel code (rows, the mask-mass and grad all-reduces) and
  equal the unwrapped step.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.composites import md17 as jmd17
from lam_slide_tpu.data.loader import Loader as JLoader
from lam_slide_tpu.parallel import fsdp as jfsdp
from lam_slide_tpu.parallel import mesh as jmesh
from lam_slide_tpu.parallel.ring_attention import reference_attention as j_reference
from lam_slide_tpu.parallel.ring_attention import sequence_parallel_attention as j_spa
from lam_slide_tpu.train.state import create_train_state as j_create_train_state
from lam_slide_tpu.train.steps import make_train_step as j_make_train_step
from lam_slide_tpu.train.trainer import TrainerConfig as JTrainerConfig
from lam_slide_tpu.train.trainer import make_optimizer as j_make_optimizer
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.data.loader import Loader
from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
from lam_slide_tpu_torch.parallel import MeshSpec, fsdp_spec, run_ranks
from lam_slide_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention_chunks,
)
from lam_slide_tpu_torch.tools.multichip_dryrun import (
    build_tiny_md17,
    tiny_md17_batch,
    tiny_md17_configs,
)
from lam_slide_tpu_torch.train import create_train_state, make_train_step
from lam_slide_tpu_torch.train.trainer import TrainerConfig, make_optimizer

from support_torch_parallel_ranks import parallel_checks

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
MOVED_TOL = 1e-2
TRAINER = dict(max_epochs=2, lr=1e-3)
RING = {"fp32": ((2, 4, 64, 16), torch.float32, 2e-5, 5e-5),
        "bf16": ((1, 2, 512, 24), torch.bfloat16, 2e-2, 2e-2)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _one_rank_step(inputs, inject, grad_accum=1, order=None):
    ss, loss_fn = build_tiny_md17()
    ss.first_stage.load_state_dict(inputs["fs_sd"])
    ss.backbone.load_state_dict(inputs["dit_sd"])
    transport = type(ss.transport)
    real = transport.sample
    if inject:
        transport.sample = lambda self, x1, generator: (inputs["t"], inputs["x0"], x1)
    try:
        tx, _ = make_optimizer(TrainerConfig(**TRAINER), 1)
        state = create_train_state(ss.backbone, tx)
        batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
        if order is not None:
            batch = {k: v[order] for k, v in batch.items()}
        state, metrics = make_train_step(loss_fn, tx, grad_accum=grad_accum)(state, batch, 0)
    finally:
        transport.sample = real
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {k: p.detach().clone() for k, p in ss.backbone.named_parameters()},
            "ema": state.ema_params}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    fs_cfg, cfg2, loss_kw = tiny_md17_configs()
    batch = tiny_md17_batch(rows_each=2)
    jfs = jmd17.build_md17_first_stage(jmd17.MD17FirstStageConfig(**dataclasses.asdict(fs_cfg)))
    frame0 = {k: v[:, 0] for k, v in _jb(batch).items() if not k.startswith("cond")}
    fs_vars = jax.tree.map(np.asarray, jax.jit(jfs.init)(jax.random.PRNGKey(0), frame0))
    jcfg2 = jmd17.MD17SecondStageConfig(**{**dataclasses.asdict(cfg2), "num_timesteps": 12})
    jss = jmd17.build_md17_second_stage(jcfg2, jfs, fs_vars)
    x1, mk = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    params = jax.tree.map(np.asarray, jax.jit(jss.backbone.init)(
        jax.random.PRNGKey(1), x1, jnp.zeros((x1.shape[0],)), mk["x_cond"], mk["x_cond_mask"],
        mk["y_class"])["params"])
    key = jax.random.PRNGKey(4)
    t, x0, _ = jss.transport.sample(jax.random.fold_in(key, jnp.int32(0)), x1)

    rng = np.random.default_rng(7)
    ring = {}
    for name, (shape, dtype, _, _) in RING.items():
        ring[name] = tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                           .to(dtype) for _ in range(4))
    inputs = {
        "batch": batch, "trainer": TRAINER, "t": torch.from_numpy(np.array(t)),
        "x0": torch.from_numpy(np.array(x0)),
        "fs_sd": convert.first_stage_state_dict_from_jax(fs_vars["params"],
                                                         fs_vars["constants"]),
        "dit_sd": convert.class_cond_dit_state_dict_from_jax(params),
        "noise": torch.from_numpy(rng.standard_normal((2, *x1.shape)).astype(np.float32)),
        "ring": ring,
    }
    path = str(tmp_path_factory.mktemp("ranks") / "inputs.pt")
    torch.save(inputs, path)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks run beside JAX's step
        ranks = pool.submit(run_ranks, parallel_checks, 2, args=(path,), timeout_s=300.0)
        jtx, _ = j_make_optimizer(JTrainerConfig(**TRAINER), 1)
        jstate = j_create_train_state({"params": params, "constants": {"first_stage": fs_vars}},
                                      jtx)
        jstate, jm = j_make_train_step(jss.make_loss(**loss_kw), jtx, donate_state=False)(
            jstate, _jb(batch), key)
        ranks = ranks.result()
    return {"inputs": inputs, "ranks": ranks, "jm": jm, "jstate": jstate,
            "params": params, "jss": jss, "fs_vars": fs_vars,
            "one": {inject: _one_rank_step(inputs, inject) for inject in (True, False)},
            # rank r's microbatch i is its i-th row: global microbatch i is
            # rows i and 2 + i, so one rank accumulates over [0, 2] then [1, 3]
            "one_accum": _one_rank_step(inputs, False, grad_accum=2, order=[0, 2, 1, 3])}


# ---------------------------------------------------------------- mesh, loader

@pytest.mark.parametrize("spec,n", [((-1, 1), 8), ((2, 4), 8), ((4, 1), 4), ((-1, 2), 8),
                                    ((3, 1), 8), ((2, 2), 2)])
def test_mesh_spec_shape_matches_jax(spec, n):
    try:
        want = jmesh.MeshSpec(*spec).shape(n)
    except ValueError as e:
        with pytest.raises(ValueError, match="does not cover"):
            MeshSpec(*spec).shape(n)
        assert "does not cover" in str(e)
        return
    assert MeshSpec(*spec).shape(n) == want


@pytest.mark.parametrize("shape", [(), (7,), (4096,), (4095,), (384, 1152), (3, 5000),
                                   (64, 64), (2, 2048, 3), (1, 4096)])
@pytest.mark.parametrize("data", [1, 2, 4, 8])
def test_fsdp_spec_matches_jax(shape, data):
    assert fsdp_spec(shape, data) == tuple(jfsdp.fsdp_spec(np.zeros(shape, np.float32), data))


class _Toy:
    """Rows that do not depend on the rng: the one-process batch is the
    concatenation of the process slices."""

    def __len__(self):
        return 23

    def sample(self, idx, rng):
        return {"x": np.full((3,), idx, np.int64), "u": np.float32(idx) * np.ones(2, np.float32)}


def _stack(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def test_loader_process_shard_matches_jax():
    whole = list(Loader(_Toy(), 8, _stack, seed=3))
    parts = []
    for pi in range(2):
        got = list(Loader(_Toy(), 8, _stack, seed=3, process_shard=(pi, 2)))
        want = list(JLoader(_Toy(), 8, _stack, seed=3, process_shard=(pi, 2)))
        assert len(got) == len(want) == len(whole) == 2
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].shape[0] == 4
        parts.append(got)
    for b, (p0, p1) in enumerate(zip(*parts)):
        for k in whole[b]:
            np.testing.assert_array_equal(np.concatenate([p0[k], p1[k]]), whole[b][k])


def test_loader_process_shard_errors_and_fallback_match_jax(monkeypatch):
    for kw in (dict(process_shard=(2, 2)), dict(process_shard=(0, 2), drop_last=False),
               dict(process_shard=(0, 3))):
        with pytest.raises(ValueError) as want:
            JLoader(_Toy(), 8, _stack, **kw)
        with pytest.raises(ValueError) as got:
            Loader(_Toy(), 8, _stack, **kw)
        assert str(got.value) == str(want.value)
    monkeypatch.setattr(Loader, "default_process_shard", (1, 2))
    monkeypatch.setattr(JLoader, "default_process_shard", (1, 2))
    for kw in (dict(), dict(drop_last=False)):
        t, j = Loader(_Toy(), 8, _stack, **kw), JLoader(_Toy(), 8, _stack, **kw)
        assert (t.process_shard, t.full_batch_feed) == (j.process_shard, j.full_batch_feed)
    assert Loader(_Toy(), 8, _stack, drop_last=False).full_batch_feed


# ---------------------------------------------------------------- DP and FSDP steps

def _close(got, want, rtol, name):
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), f"{name}: {got} vs {want}"


def _params_close(got, want, name):
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        assert err <= GRAD_TOL * w.abs().max().item(), f"{name} {k}: {err}"


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_step_matches_one_rank_and_jax(world, mode):
    r0, r1 = (world["ranks"][r][(mode, True)] for r in (0, 1))
    assert r0["mask_sum"] != r1["mask_sum"]  # the ranks' masks differ
    one = world["one"][True]
    _close(r0["loss"], one["loss"], LOSS_RTOL, "loss vs one rank")
    _close(r0["loss"], float(world["jm"]["loss"]), LOSS_RTOL, "loss vs JAX")
    _close(r0["grad_norm"], one["grad_norm"], LOSS_RTOL, "grad norm vs one rank")
    _close(r0["grad_norm"], float(world["jm"]["grad_norm"]), GRAD_TOL, "grad norm vs JAX")
    for r in (r0, r1):
        _params_close(r["params"], one["params"], "params")
        _params_close(r["ema"], one["ema"], "ema")
    start = world["inputs"]["dit_sd"]
    want = convert.class_cond_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, world["jstate"].params))
    for k, p in r0["params"].items():
        moved = want[k] - start[k]
        if moved.norm() == 0:
            continue
        err = (p - want[k]).norm()
        assert err <= MOVED_TOL * moved.norm(), f"{k}: {err} > {MOVED_TOL} x {moved.norm()}"


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_step_draws_the_one_rank_noise(world, mode):
    """Without injection each rank draws the global batch's t and x0 from
    the step's generator and keeps its rows: the one-rank step's draws."""
    one = world["one"][False]
    for rank in (0, 1):
        got = world["ranks"][rank][(mode, False)]
        _close(got["loss"], one["loss"], LOSS_RTOL, "loss")
        _params_close(got["params"], one["params"], "params")
    assert one["loss"] != world["one"][True]["loss"]


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_grad_accum_reduces_once(world, mode):
    """grad_accum=2 on 2 ranks: each rank's i-th slice joins microbatch i,
    the grads are reduced once after the last microbatch (FSDP2 syncs only
    then), and the step is the one-rank accumulating step over the same
    microbatches."""
    one = world["one_accum"]
    for rank in (0, 1):
        got = world["ranks"][rank][(mode, "accum")]
        _close(got["loss"], one["loss"], LOSS_RTOL, "loss")
        _params_close(got["params"], one["params"], "params")
        assert got["grad_reduces"] == (1 if mode == "dp" else 0)
    assert world["ranks"][0][(mode, True)]["grad_reduces"] == (1 if mode == "dp" else 0)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_one_rank_group_runs_the_data_parallel_path(world, tmp_path, monkeypatch, mode):
    """On a data axis of one rank (the one card's case) the wrapped step
    still runs the data-parallel code: its batch carries rows, its masked
    means all-reduce their mask mass over the group, and the DP step
    all-reduces its grads once (FSDP2 reduce-scatters them itself). The
    step is the unwrapped one-rank step."""
    import torch.distributed as dist

    from lam_slide_tpu_torch.parallel import init_distributed, make_mesh
    from lam_slide_tpu_torch.parallel import rows as prow
    from support_torch_parallel_ranks import _md17_step

    mass = []
    real = prow.all_reduce_sum
    monkeypatch.setattr(prow, "all_reduce_sum",
                        lambda t, group=None: mass.append(1) or real(t, group))
    init_distributed("gloo", rank=0, world_size=1, init_method=f"file://{tmp_path}/rendezvous")
    try:
        got = _md17_step(world["inputs"], make_mesh(MeshSpec()), mode == "fsdp", True)
    finally:
        dist.destroy_process_group()
    assert got["grad_reduces"] == (1 if mode == "dp" else 0)
    assert mass  # the masked means took the group's mask mass
    one = world["one"][True]
    _close(got["loss"], one["loss"], LOSS_RTOL, "loss vs unwrapped")
    _params_close(got["params"], one["params"], "params")
    _params_close(got["ema"], one["ema"], "ema")


def test_per_rank_masked_means_would_differ(world):
    """The trap the global mask mass avoids: the mean of the ranks' own
    masked means is not the global batch's loss."""
    inputs = world["inputs"]
    ss, loss_fn = build_tiny_md17()
    ss.first_stage.load_state_dict(inputs["fs_sd"])
    ss.backbone.load_state_dict(inputs["dit_sd"])
    batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
    transport = type(ss.transport)
    real = transport.sample
    losses = []
    try:
        for sl in (slice(0, 2), slice(2, 4)):
            transport.sample = lambda self, x1, g, sl=sl: (inputs["t"][sl], inputs["x0"][sl], x1)
            with torch.no_grad():
                losses.append(float(loss_fn(ss.backbone, {k: v[sl] for k, v in batch.items()},
                                            None, True)[0]))
    finally:
        transport.sample = real
    naive = np.mean(losses)
    assert abs(naive - world["one"][True]["loss"]) > 100 * LOSS_RTOL * world["one"][True]["loss"]


def test_fsdp_shards_most_parameter_bytes(world):
    share = world["ranks"][0][("fsdp", True)]["share"]
    assert share["share"] > 0.5 and share["sharded_bytes"] == share["total_bytes"] == 241184
    leaves = jax.tree.leaves(world["params"])
    jax_sharded = sum(leaf.nbytes for leaf in leaves if jfsdp.fsdp_spec(leaf, 2) != ())
    assert jax_sharded == 163840
    assert share["jax_rule_share"] == pytest.approx(jax_sharded / share["total_bytes"])


def test_fsdp_weight_cache_trap(world):
    d, m, group = 16, 32, 8
    w1 = torch.randn(3 * d + m, d)
    w2 = torch.randn(d, d + m)
    old = fsb._tiled_operands(w1, w2, d, m, group, d)[0].clone()
    with torch.no_grad(), torch.autograd._unsafe_preserve_version_counter(w1):
        w1.add_(1.0)  # what FSDP2's all-gather does to the gathered weight
    assert torch.equal(fsb._tiled_operands(w1, w2, d, m, group, d)[0], old)  # stale
    fsb.clear_weight_cache()
    assert torch.equal(fsb._tiled_operands(w1, w2, d, m, group, d)[0], old + 1.0)
    for rank in (0, 1):
        fresh = world["ranks"][rank]["cache_trap"]
        assert len(fresh) == 3 and all(fresh)


# ---------------------------------------------------------------- ring attention

@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax(world, name):
    """fp32: the output and grads against JAX's ring on its 8-device mesh
    and its reference; bf16: the output against both (as JAX's own bf16
    test), the grads against the port's plain attention's."""
    _, dtype, tol, gtol = RING[name]
    q, k, v, g = world["inputs"]["ring"][name]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v, g))
    jmesh8 = jmesh.make_mesh(jmesh.MeshSpec(data=1, model=8))

    def jax_out(fn):
        if dtype != torch.float32:
            return [np.asarray(fn(jq, jk, jv), np.float32)]
        out, vjp = jax.vjp(fn, jq, jk, jv)
        return [np.asarray(t, np.float32) for t in (out, *vjp(jg))]

    want = jax_out(lambda a, b, c: j_spa(a, b, c, jmesh8))
    ref = jax_out(j_reference)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    plain = reference_attention(qs, ks, vs)
    plain = [plain.detach(), *torch.autograd.grad(plain, (qs, ks, vs), g)]
    out = torch.cat(ring_attention_chunks(qs.chunk(8, 2), ks.chunk(8, 2), vs.chunk(8, 2)), 2)
    chunks8 = [out.detach(), *torch.autograd.grad(out, (qs, ks, vs), g)]
    r0, r1 = (world["ranks"][r]["ring"][name] for r in (0, 1))
    torch.testing.assert_close(r1[0], r0[0], rtol=0, atol=0)  # the same output on each rank
    # each rank's grads fill its own chunk of q, k and v: their sum is the whole
    two_ranks = [r0[0], *(a + b for a, b in zip(r0[1:], r1[1:]))]
    for got in (chunks8, two_ranks):
        for i, a in enumerate(got):
            t = tol if i == 0 else gtol
            for w in ((want[i], ref[i]) if i < len(want) else ()):
                np.testing.assert_allclose(a.float().numpy(), w, rtol=t, atol=t)
            torch.testing.assert_close(a.float(), plain[i].float(), rtol=t, atol=t)


# ---------------------------------------------------------------- sampling

def test_sharded_sample_matches_one_rank(world):
    inputs = world["inputs"]
    ss, _ = build_tiny_md17()
    ss.first_stage.load_state_dict(inputs["fs_sd"])
    ss.backbone.load_state_dict(inputs["dit_sd"])
    sample_k = ss.make_k_sample_fn(k=2, sampling_method="ODE",
                                   sampling_kwargs={"sampling_method": "euler", "num_steps": 10})
    with torch.no_grad():
        want = sample_k({k: torch.as_tensor(v) for k, v in inputs["batch"].items()},
                        noise=inputs["noise"])["pos"]
    for rank in (0, 1):
        got = world["ranks"][rank]["sample"]
        assert got.shape == want.shape == (2, 4, 12, 16, 3)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
