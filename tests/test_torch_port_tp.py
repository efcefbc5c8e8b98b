"""The port's tensor parallelism (parallel/tp.py) against the JAX package's,
on the CPU.

The two-rank cases run once, in a module fixture: two gloo ranks (a data 1
x model 2 mesh) spawned by ``parallel.run_ranks`` run
``tests/support_torch_tp_ranks.tp_checks`` while JAX runs its side here.

* the layout rule (``dit_tp_spec``) against JAX's on the same parameters:
  linear1's rows and linear2's columns split where JAX splits linear1's
  and linear2's kernels, everything else replicated, and a block whose heads
  or MLP width the model axis does not divide whole (also where JAX would
  split its fused columns: 3 x 128 at tp 2);
* shard -> gather of ``convert``'s whole weights, bit for bit;
* at 16 x 24 (tp 2, 4) and 3 x 128 (tp 3), fp32: the sum over the ranks
  of K8's plain partial plus b2 against JAX ``_reference_spatial_block``
  and ``fused_spatial_block`` in interpret mode, and the sharded long-axis
  block against JAX's ``ParallelMLPAttention``, within 1e-5 of the largest
  output;
* one TP step (two gloo ranks, and two shards in one process) of
  tests/test_tp.py's tiny DiT and of the multichip dry run's tiny MD17
  stage 2, with JAX's t and x0 injected: against the port's one-rank step,
  the loss and the grad norm within 2e-5 and the updated parameters within
  rtol 2e-4 / atol 1e-5 (tests/test_tp.py:84-96's limits, TP against DP in
  one framework); against JAX's one-device step the loss within 2e-5 and
  what the update moved within MOVED_TOL of its norm, parameters and EMA
  (tests/test_torch_port_train.py's limit for one step across the two
  frameworks: Adam moves a parameter by lr wherever its grad is not ~0, so
  a grad that is fp32 noise in one framework can move it either way);
* per-rank parameter and AdamW-moment shapes after a step;
* checkpoints both ways: a TP state saved by the ranks loads in a one-rank
  model and restores into a fresh TP state; a one-rank checkpoint restores
  into a TP state as its slices;
* TP with FSDP2 raises JAX's message; an fp32 per-rank K8 call on a
  device that is neither the CPU nor CUDA raises, and nothing falls back;
* K8's routes at the per-rank widths of every composite and of the smoke
  registries: ``sm90_plan`` (the WMMA route below a Hopper head group) and
  ``f32_plan`` (the outer-product route at the 4AA splits the card runs),
  and the outer-product kernel's w1 stream of a rank whose MLP width is
  below D.

Inputs come from numpy seeds and JAX inits; fp32 on both sides.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from jax.tree_util import DictKey

from lam_slide_tpu.composites import md17 as jmd17
from lam_slide_tpu.models import LatentDiT as JLatentDiT
from lam_slide_tpu.models.latent_dit import ParallelMLPAttention as JPMA
from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import fused_spatial_block as jsb
from lam_slide_tpu.ops.packed_attention import lane_rope_tables
from lam_slide_tpu.parallel.tp import dit_tp_spec as j_dit_tp_spec
from lam_slide_tpu.train.state import create_train_state as j_create_train_state
from lam_slide_tpu.train.steps import make_train_step as j_make_train_step
from lam_slide_tpu.train.trainer import TrainerConfig as JTrainerConfig
from lam_slide_tpu.train.trainer import make_optimizer as j_make_optimizer
from lam_slide_tpu.transport import create_transport as j_create_transport
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.models.latent_dit import ParallelMLPAttention, rope_cos_sin
from lam_slide_tpu_torch.ops import fused_spatial_block as tsb
from lam_slide_tpu_torch.parallel import dit_tp_spec, gather_state_dict, run_ranks, tp
from lam_slide_tpu_torch.tools.multichip_dryrun import tiny_md17_batch, tiny_md17_configs
from lam_slide_tpu_torch.train import create_train_state
from lam_slide_tpu_torch.train.checkpoint import CheckpointManager
from lam_slide_tpu_torch.train.trainer import TrainerConfig, make_optimizer

from support_torch_tp_ranks import dit_loss, tiny_dit, tiny_md17, tp_checks, tp_step

CFG = dict(depth=2, in_dim=8, hidden_size=32, num_heads=4, mlp_ratio=2)  # tests/test_tp.py
B, T, L = 8, 12, 2
TRAINER = dict(max_epochs=2, lr=1e-3)
LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5
MOVED_TOL = 1e-2
GRAD_RTOL = 1e-4  # the grad norm across the two frameworks (test_torch_port_train.py)
BLOCK_REL = 1e-5  # fp32: only the order of fp32 sums differs
SMEM_MAX = 232448
# (hidden, heads) of the composites' DiTs (tests/test_torch_port_spatial_tiles.py)
COMPOSITE_WIDTHS = [(384, 16), (384, 3), (256, 16), (128, 4)]
# (hidden, heads, tp) of the 4AA splits this slice runs on the card
RANK_WIDTHS = [(384, 16, 2), (384, 16, 4), (384, 3, 3)]
# ... and the ranks below a Hopper head group: 4AA 16 x 24 at tp 8 (Da 48),
# the pedestrian DiT at tp 4 and NBA at tp 8 (Da 32)
NARROW_RANKS = [(384, 16, 8), (128, 4, 4), (256, 16, 8)]
# (hidden, heads, MLP width, tps) of every DiT a rank runs: the composites'
# and the --smoke registries' hidden 32 (4 heads) and 16 (2 heads), at
# every tp up to 8 that the layout rule shards
ALL_RANK_DITS = [(384, 16, 768, (2, 4, 8)), (384, 3, 768, (3,)), (256, 16, 512, (2, 4, 8)),
                 (128, 4, 256, (2, 4)), (32, 4, 64, (2, 4)), (16, 2, 32, (2,))]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dit_side():
    """tests/test_tp.py's DiT (torch-default init, so every block weight
    gets a grad) and batch, JAX's loss and one JAX step."""
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((B, T, L, CFG["in_dim"])).astype(np.float32)
    mask = np.zeros((B, T, L), np.int32)
    mask[:, :1] = 1
    batch = {"x1": x1, "x_cond": x1 * mask[..., None], "mask": mask}
    jmodel = JLatentDiT(**CFG, n_timesteps=T, reference_init=False)
    params = _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x1),
                                           jnp.zeros((B,)), jnp.asarray(batch["x_cond"]),
                                           jnp.asarray(mask))["params"])
    jtr = j_create_transport(path_type="GVP", prediction="data")

    def loss_fn(p, constants, b, key, train):
        out = jtr.training_losses(
            key, lambda xt, tt, **kw: jmodel.apply({"params": p}, xt, tt, **kw), b["x1"],
            model_kwargs={"x_cond": b["x_cond"], "x_cond_mask": b["mask"]})
        loss = out["loss"].mean()
        return loss, {"si_loss": loss}

    key = jax.random.PRNGKey(3)
    t, x0, _ = jtr.sample(jax.random.fold_in(key, jnp.int32(0)), jnp.asarray(x1))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch.update(t=torch.from_numpy(np.array(t)), x0=torch.from_numpy(np.array(x0)))
    return params, loss_fn, key, batch, tbatch


def _md17_side():
    """The multichip dry run's tiny MD17 (test_torch_port_parallel.py's
    world): JAX's init, the t and x0 of its step 0, the converted weights."""
    fs_cfg, cfg2, loss_kw = tiny_md17_configs()
    batch = tiny_md17_batch(rows_each=2)
    jfs = jmd17.build_md17_first_stage(jmd17.MD17FirstStageConfig(**dataclasses.asdict(fs_cfg)))
    frame0 = {k: v[:, 0] for k, v in _jb(batch).items() if not k.startswith("cond")}
    fs_vars = _np_tree(jax.jit(jfs.init)(jax.random.PRNGKey(0), frame0))
    jcfg2 = jmd17.MD17SecondStageConfig(**{**dataclasses.asdict(cfg2), "num_timesteps": 12})
    jss = jmd17.build_md17_second_stage(jcfg2, jfs, fs_vars)
    x1, mk = jax.jit(jss.prepare_batch)(fs_vars, _jb(batch))
    params = _np_tree(jax.jit(jss.backbone.init)(
        jax.random.PRNGKey(1), x1, jnp.zeros((x1.shape[0],)), mk["x_cond"], mk["x_cond_mask"],
        mk["y_class"])["params"])
    key = jax.random.PRNGKey(4)
    t, x0, _ = jss.transport.sample(jax.random.fold_in(key, jnp.int32(0)), x1)
    return jss, fs_vars, params, key, batch, loss_kw, t, x0


def _jax_step(loss_fn, params, constants, batch, key):
    jtx, _ = j_make_optimizer(JTrainerConfig(**TRAINER), 1)
    state = j_create_train_state({"params": params, "constants": constants}, jtx)
    state, metrics = j_make_train_step(loss_fn, jtx, donate_state=False)(state, _jb(batch), key)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": _np_tree(state.params), "ema": _np_tree(state.ema_params)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    dparams, dloss, dkey, dbatch, tbatch = _dit_side()
    jss, fs_vars, mparams, mkey, mbatch, loss_kw, mt, mx0 = _md17_side()
    inputs = {"trainer": TRAINER, "dit_cfg": CFG, "dit_batch": tbatch,
              "dit_sd": convert.latent_dit_state_dict_from_jax(dparams),
              "fs_sd": convert.first_stage_state_dict_from_jax(fs_vars["params"],
                                                               fs_vars["constants"]),
              "md17_sd": convert.class_cond_dit_state_dict_from_jax(mparams),
              "md17_batch": mbatch, "md17_t": torch.from_numpy(np.array(mt)),
              "md17_x0": torch.from_numpy(np.array(mx0))}
    work = tmp_path_factory.mktemp("tp")
    path = str(work / "inputs.pt")
    torch.save(inputs, path)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks run beside JAX's steps
        ranks = pool.submit(run_ranks, tp_checks, 2, args=(path,), timeout_s=300.0)
        jax_dit = _jax_step(dloss, dparams, {}, dbatch, dkey)
        jax_md17 = _jax_step(jss.make_loss(**loss_kw), mparams, {"first_stage": fs_vars},
                             mbatch, mkey)
        ranks = ranks.result()
    md17_batch = {k: torch.as_tensor(v) for k, v in mbatch.items()}

    def one(kind, size=None):
        if kind == "dit":
            return tp_step(tiny_dit(inputs["dit_sd"], CFG), dit_loss, tbatch, TRAINER,
                           size=size or 1)
        ss, loss_fn = tiny_md17(inputs)
        return tp_step(ss.backbone, loss_fn, md17_batch, TRAINER, size=size or 1)

    return {"inputs": inputs, "ranks": ranks, "work": work,
            "jax": {"dit": (jax_dit, convert.latent_dit_state_dict_from_jax),
                    "md17": (jax_md17, convert.class_cond_dit_state_dict_from_jax)},
            "one": {k: one(k) for k in ("dit", "md17")},
            "in_process": {k: one(k, 2) for k in ("dit", "md17")}}


# ---------------------------------------------------------------- the layout

_JAX_LEAVES = {"linear1.weight": ("linear1",), "linear1.bias": ("linear1_bias",),
               "linear2.weight": ("linear2", "kernel"), "linear2.bias": ("linear2", "bias")}


@pytest.mark.parametrize("hidden,heads,size", [(32, 4, 2), (32, 4, 4), (32, 4, 3), (384, 16, 4),
                                               (384, 3, 2), (384, 3, 3)])
def test_layout_rule_matches_jax(hidden, heads, size):
    """Every block parameter's spec against JAX's on the same leaf (kernels
    transposed: nn.Linear's [out, in] is JAX's [in, out]); the rest of the
    DiT replicated on both sides."""
    m = 2 * hidden
    shapes = {"linear1.weight": (3 * hidden + m, hidden), "linear1.bias": (3 * hidden + m,),
              "linear2.weight": (hidden, hidden + m), "linear2.bias": (hidden,)}
    whole = heads % size == 0  # the port splits whole heads only
    for suffix, shape in shapes.items():
        name = f"blocks.0.spatial_block.{suffix}"
        path = tuple(DictKey(k) for k in ("block_0", "spatial_block", *_JAX_LEAVES[suffix]))
        jshape = shape[::-1] if len(shape) == 2 else shape
        jspec = j_dit_tp_spec(path, jnp.zeros(jshape), size)
        got = dit_tp_spec(name, shape, size, heads, hidden)
        want = tuple(jspec)[::-1] if len(shape) == 2 else tuple(jspec)
        if whole:
            assert got == want, (suffix, got, jspec)
            assert (got != ()) == (suffix != "linear2.bias")
        else:
            assert got == (), (suffix, got)
    for name, shape in (("blocks.0.modulation.lin.weight", (6 * hidden, hidden)),
                        ("x_in.weight", (hidden, 8)), ("linear.weight", (8, hidden))):
        assert dit_tp_spec(name, shape, size, heads, hidden) == ()
    if (hidden, heads, size) == (384, 3, 2):
        # JAX cuts the 1,920 fused columns in two; the port keeps the block whole
        path = tuple(DictKey(k) for k in ("block_0", "spatial_block", "linear1"))
        assert j_dit_tp_spec(path, jnp.zeros((hidden, 3 * hidden + m)), 2) == P(None, "model")


@pytest.mark.parametrize("size", [2, 4])
def test_shard_gather_is_bit_for_bit(world, size):
    """convert's whole weights -> shards -> whole again, bit for bit; a
    shard is a contiguous tensor of its own with rank r's heads."""
    model = tiny_dit(world["inputs"]["dit_sd"], CFG)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    tp.shard_model(model, tp.in_process(size))
    names = [n for n, _ in model.named_parameters()]
    assert "blocks.0.spatial_block.linear1.weight" not in names
    shard = model.blocks[0].temporal_block.shards[size - 1]
    d, m = CFG["hidden_size"], 2 * CFG["hidden_size"]
    da = d // size
    assert shard.linear1.weight.is_contiguous() and shard.linear2.weight.is_contiguous()
    assert torch.equal(shard.linear1.weight[:da],
                       want["blocks.0.temporal_block.linear1.weight"][d - da:d])
    got = gather_state_dict(model)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ema = tp.shard_tree(model, want)
    assert set(ema) == set(model.state_dict())
    assert all(torch.equal(a, want[k]) for k, a in tp.gather_tree(model, ema).items())


# ---------------------------------------------------------------- the blocks

def _block_weights(rng, d, m):
    """JAX-layout fp32 weights of one block."""
    w1 = (rng.standard_normal((d, 3 * d + m)) * d ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(3 * d + m) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((d + m, d)) * (d + m) ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return w1, b1, w2, b2


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("d,heads,size", RANK_WIDTHS + NARROW_RANKS,
                         ids=["16x24tp2", "16x24tp4", "3x128tp3", "16x24tp8", "ped4x32tp4",
                              "nba16x16tp8"])
def test_k8_partials_sum_to_jax(monkeypatch, d, heads, size):
    """The ranks' plain K8 partials, summed, plus b2 against the JAX
    block's composition and its kernel in interpret mode."""
    rng = np.random.default_rng(d + heads + size)
    n, l, m, dh = 5, 2, 2 * d, d // heads
    x = rng.standard_normal((n, l, d)).astype(np.float32)
    w1, b1, w2, b2 = _block_weights(rng, d, m)
    qs, ks = ((np.abs(rng.standard_normal(dh)) + 0.5).astype(np.float32) for _ in range(2))
    cos_l, sin_l = lane_rope_tables(*j_rope_cos_sin(l, dh), heads)
    jargs = (jnp.asarray(x), *(jnp.asarray(a) for a in (w1, b1, qs, ks, w2, b2)), cos_l, sin_l,
             heads)
    want_ref = np.asarray(jsb._reference_spatial_block(*jargs, dh ** -0.5))
    monkeypatch.setattr(jsb, "FORCE_KERNEL", True)
    want_kernel = np.asarray(jsb.fused_spatial_block(*jargs))
    t = torch.from_numpy
    tw1, tw2 = t(w1.T.copy()), t(w2.T.copy())
    cos, sin = rope_cos_sin(l, dh)
    parts = [tsb.reference_spatial_block(
        t(x), tp.slice_linear1(tw1, d, m, size, r), tp.slice_linear1(t(b1), d, m, size, r),
        t(qs), t(ks), tp.slice_linear2(tw2, d, m, size, r), None, cos, sin, heads // size,
        dh ** -0.5, attn_width=d // size, partial=True) for r in range(size)]
    assert all(p.dtype == torch.float32 and p.shape == x.shape for p in parts)
    got = (sum(parts[1:], parts[0]) + t(b2)).numpy()
    assert _rel(got, want_ref) <= BLOCK_REL
    assert _rel(got, want_kernel) <= BLOCK_REL


@pytest.mark.parametrize("d,heads,size", RANK_WIDTHS, ids=["16x24tp2", "16x24tp4", "3x128tp3"])
def test_long_axis_block_matches_jax(d, heads, size):
    """ParallelMLPAttention on a 20-position axis (K3's route at dh 24, K5's
    at dh 128; K2's MLP at d_mid = M/tp), split into ``size`` shards in one
    process, against JAX's block on the converted weights."""
    rng = np.random.default_rng(d * size)
    n = 20
    x = rng.standard_normal((2, n, d)).astype(np.float32)
    cos, sin = j_rope_cos_sin(n, d // heads)
    jmod = JPMA(hidden_size=d, num_heads=heads, mlp_ratio=2.0, reference_init=False)
    params = _np_tree(jmod.init(jax.random.PRNGKey(size), jnp.asarray(x), cos, sin)["params"])
    for name in ("q_norm_scale", "k_norm_scale"):
        params[name] = rng.uniform(0.5, 1.5, params[name].shape).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), cos, sin))
    port = ParallelMLPAttention(d, heads, 2.0, False, 8, torch.float32,
                                torch.Generator().manual_seed(0))
    sd = {}
    convert._pma(sd, "m", params)
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    whole = port(torch.from_numpy(x), *rope_cos_sin(n, d // heads)).detach().numpy()
    tp.shard_model(port, tp.in_process(size))
    assert port.tp is not None and len(port.shards) == size
    got = port(torch.from_numpy(x), *rope_cos_sin(n, d // heads)).detach().numpy()
    assert _rel(got, want) <= BLOCK_REL
    assert _rel(got, whole) <= BLOCK_REL


# ---------------------------------------------------------------- the step

STEPS = [("dit", "ranks"), ("dit", "in_process"), ("md17", "ranks"), ("md17", "in_process")]


def _result(world, kind, where):
    if where == "ranks":
        return world["ranks"][0][kind]
    return world["in_process"][kind]


def _close(got, want, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{what} {k}")


def _moved_alike(start, got, want, what):
    for k, w in want.items():
        moved = (w - start[k]).norm()
        assert moved > 0, f"{what} {k} did not move"
        err = (got[k] - w).norm()
        assert err <= MOVED_TOL * moved, f"{what} {k}: {err} > {MOVED_TOL} x {moved}"


@pytest.mark.parametrize("kind,where", STEPS)
def test_tp_step_matches_jax(world, kind, where):
    """Loss, updated parameters and EMA of the TP step against JAX's
    one-device step on the same weights, batch, t and x0."""
    got = _result(world, kind, where)
    want, to_port = world["jax"][kind]
    start = world["inputs"]["dit_sd" if kind == "dit" else "md17_sd"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GRAD_RTOL)
    _moved_alike(start, got["params"], to_port(want["params"]), "param")
    _moved_alike(start, got["ema"], to_port(want["ema"]), "ema")


@pytest.mark.parametrize("kind,where", STEPS)
def test_tp_step_equals_the_one_rank_step(world, kind, where):
    """The same against the port's unsharded step, and the grad norm of one
    rank's (the slices' squares summed over the model group once)."""
    got, one = _result(world, kind, where), world["one"][kind]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=LOSS_RTOL)
    assert set(got["params"]) == set(one["params"])
    _close(got["params"], {k: v.numpy() for k, v in one["params"].items()}, "param")
    _close(got["ema"], {k: v.numpy() for k, v in one["ema"].items()}, "ema")
    if where == "ranks":
        other = world["ranks"][1][kind]
        assert other["loss"] == got["loss"] and other["grad_norm"] == got["grad_norm"]
        for k, v in got["params"].items():
            assert torch.equal(v, other["params"][k]), k


@pytest.mark.parametrize("kind", ["dit", "md17"])
def test_rank_shapes_after_a_step(world, kind):
    """Each rank holds one shard a block: linear1 [3 Da + Mr, D], its bias,
    linear2 [D, Da + Mr]; its AdamW moments are laid out alike; the rest is
    whole."""
    d = 32  # both tiny DiTs: hidden 32, 4 heads, mlp 2x
    da, mr = d // 2, d
    one = world["one"][kind]["shapes"]
    for rank in world["ranks"]:
        assert rank["model_rank"] in (0, 1)
        shapes, mu = rank[kind]["shapes"], rank[kind]["mu_shapes"]
        assert mu == shapes
        split = [k for k in shapes if ".shards." in k]
        assert len(split) == 3 * 2 * 2  # 3 tensors x 2 blocks a layer x depth 2
        for k in split:
            want = {"linear1.weight": (3 * da + mr, d), "linear1.bias": (3 * da + mr,),
                    "linear2.weight": (d, da + mr)}[k.split(".shards.0.")[1]]
            assert shapes[k] == want, k
        for k, s in shapes.items():
            if ".shards." not in k:
                assert one[k] == s, k


def test_checkpoints_between_tp_and_one_rank(world, tmp_path):
    """The ranks' checkpoint holds whole tensors under the one-rank names
    (it loads strictly in a one-rank model, equal to the gathered state) and
    restores into a fresh TP state as each rank's slices; a one-rank
    checkpoint restores into a TP state held in one process."""
    ranks = world["ranks"]
    for rank in ranks:
        ck = rank["checkpoint"]
        for k, v in ck["saved"].items():
            assert torch.equal(ck["restored"][k], v), k
        for k, v in ck["mu_saved"].items():
            assert torch.equal(ck["mu_restored"][k], v), k
    raw = torch.load(world["work"] / "ckpt" / "checkpoints" / "last.pt", weights_only=True)
    model = tiny_dit(world["inputs"]["dit_sd"], CFG)
    model.load_state_dict(raw["params"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, ranks[0]["dit"]["params"].get(k, v)), k
    assert set(raw["opt_state"]["mu"]) == {n for n, _ in model.named_parameters()}

    # one rank -> TP in one process
    tx, _ = make_optimizer(TrainerConfig(**TRAINER), 1)
    one = create_train_state(model, tx)
    CheckpointManager(str(tmp_path)).save(one, {"loss": 1.0})
    fresh = tiny_dit(world["inputs"]["dit_sd"], CFG)
    state = tp.shard_train_state(create_train_state(fresh, tx), size=2)
    CheckpointManager(str(tmp_path)).restore(state, "last")
    want = tp.shard_tree(fresh, dict(model.state_dict()))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_tp_with_fsdp_raises(world):
    for rank in world["ranks"]:
        assert rank["fsdp"] == ("fsdp composes with the data axis only; "
                                "use either --model-axis or fsdp")


def test_fp32_rank_block_off_the_cpu_raises():
    """An fp32 rank's K8 call on a device that is neither the CPU nor CUDA
    (``meta``) raises ValueError naming the device it wants, and nothing
    falls back: no counter moves."""
    d, m, heads, size = 384, 768, 16, 2
    f = dict(dtype=torch.float32, device="meta")
    args = (torch.zeros(4, 2, d, **f), torch.zeros(3 * d // size + m // size, d, **f),
            torch.zeros(3 * d // size + m // size, **f), torch.ones(24, **f),
            torch.ones(24, **f), torch.zeros(d, d // size + m // size, **f), None,
            torch.ones(2, 12, **f), torch.ones(2, 12, **f), heads // size, 24 ** -0.5)
    names = ("launches", "wmma_launches", "f32_launches", "f32_tiled_launches",
             "f32_dot_launches", "tp_partial_launches")
    before = [getattr(tsb, name) for name in names]
    with pytest.raises(ValueError, match="CUDA device"):
        tsb.fused_spatial_block(*args, attn_width=d // size, partial=True)
    assert [getattr(tsb, name) for name in names] == before


def _wmma_smem(d: int, da: int, mr: int) -> int:
    """Shared memory of the WMMA kernel's block (``Layout`` in
    csrc/fused_spatial_block.cu) for a rank: the 32-row x tile, the whole
    linear1 output at sections of S columns, the warps' fp32 scratch."""
    def align(v):
        return -(-v // 128) * 128
    s = -(-da // 16) * 16
    w_off = align(32 * (d + 8) * 2)
    c_off = align(w_off + 32 * (3 * s + mr + 8) * 2)
    return align(c_off + 8 * 16 * 20 * 4)


@pytest.mark.parametrize("d,heads", COMPOSITE_WIDTHS)
def test_sm90_plan_at_rank_widths(d, heads):
    """K8's Hopper plan at every tp of 2 to 8 that divides the heads and the
    MLP width, wherever a rank's attention width is a whole number of the
    instance's head groups (shared memory within 227 KB); where it is not
    (4AA 16 x 24 at tp 8: 48 columns under a group of 96; the pedestrian
    DiT at tp 4 and NBA at tp 8: 32 under 64) there is no plan, and the
    rank's bf16 call takes the WMMA route: its shared memory fits, its
    sections need no padding."""
    m = 2 * d
    for size in range(2, 9):
        if heads % size or m % size:
            continue
        da = d // size
        group = tsb.SM90_GROUPS[(d, d // heads)]
        plan = tsb.sm90_plan(16000 // 2, 2, d, m // size, heads // size, attn_width=da)
        if da % group:
            assert plan is None, (d, heads, size)
            w1 = torch.zeros(3 * da + m // size, d)
            w2 = torch.zeros(d, da + m // size)
            ops = tsb._wmma_operands(w1, w1[:, 0], w2, da, m // size)
            assert ops[0] is w1 and ops[2] is w2 and ops[3] == da  # Da % 16 == 0
            assert _wmma_smem(d, da, m // size) <= SMEM_MAX, (d, heads, size)
            continue
        assert plan is not None and plan.smem <= SMEM_MAX, (d, heads, size, plan)
        assert plan == tsb.sm90_plan(8000, 2, d, m, heads)._replace(smem=plan.smem)


def test_k8_routes_at_every_rank_width():
    """Every rank of every DiT a rank runs (``ALL_RANK_DITS``) has a K8
    route on the card in both dtypes, at L 1, 2 and 8: in fp32 a plan whose
    shared memory fits, the outer-product kernel at the three 4AA splits of
    chip_smoke.py's TP_SPLITS (16 x 24 tp 2 and 4, 3 x 128 tp 3) and at NBA
    tp 2 and 4, the dot-product kernel below an instance's head group; in
    bf16 the Hopper plan or, where it has none, the WMMA route within its
    shared memory, the tiny ranks' Da 8 padded to sections of 16 whose
    added rows and columns are zero and whose kept ones are the weights'."""
    tiled = {(384, 16, 2), (384, 16, 4), (384, 3, 3), (256, 16, 2), (256, 16, 4)}
    rng = np.random.default_rng(25)
    for d, heads, m, sizes in ALL_RANK_DITS:
        for size in sizes:
            assert tp.divides(heads, m, size), (d, heads, size)
            da, mr, h = d // size, m // size, heads // size
            for l in (1, 2, 8):
                f32 = tsb.f32_plan(4000, l, d, mr, h, attn_width=da)
                assert f32 is not None and f32.smem <= SMEM_MAX, (d, heads, size)
                assert f32.route == ("tiled" if (d, heads, size) in tiled else "dot"), (
                    d, heads, size, f32)
                assert da % f32.group == 0 and f32.group % (da // h) == 0
                if tsb.sm90_plan(4000, l, d, mr, h, attn_width=da) is None:
                    assert _wmma_smem(d, da, mr) <= SMEM_MAX
            w1 = torch.from_numpy(rng.standard_normal((3 * da + mr, d)).astype(np.float32))
            b1 = w1[:, 0].contiguous()
            w2 = torch.from_numpy(rng.standard_normal((d, da + mr)).astype(np.float32))
            w1p, b1p, w2p, sec = tsb._wmma_operands(w1, b1, w2, da, mr)
            assert sec % 16 == 0 and sec - da < 16
            assert w1p.shape == (3 * sec + mr, d) and w2p.shape == (d, sec + mr)
            for i in range(3):
                assert torch.equal(w1p[i * sec:i * sec + da], w1[i * da:(i + 1) * da])
                assert torch.equal(b1p[i * sec:i * sec + da], b1[i * da:(i + 1) * da])
                assert not w1p[i * sec + da:(i + 1) * sec].any()
            assert torch.equal(w1p[3 * sec:], w1[3 * da:])
            assert torch.equal(w2p[:, :da], w2[:, :da]) and torch.equal(w2p[:, sec:], w2[:, da:])
            assert not w2p[:, da:sec].any()


@pytest.mark.parametrize("d,heads,size", [(384, 16, 4), (384, 3, 3), (256, 16, 4)])
def test_k8_f32_rank_stream(d, heads, size):
    """The outer-product kernel's w1 stream of a rank whose MLP width is
    below D (4AA 16 x 24 tp 4: 192 of 384; 3 x 128 tp 3: 256; NBA tp 4: 128
    of 256): the rank's head groups' q, k and v passes over its Da columns,
    then one MLP pass of its M/tp columns padded to D with zeros, each
    32-row slice of a pass one contiguous run holding w1[cols, k0:k0+32]^T;
    w2^T ``[Da + M/tp, D]``; the kept operands are keyed on Da, so the same
    tensors at another Da get a stream of their own."""
    m = 2 * d
    da, mr, h = d // size, m // size, heads // size
    group = tsb.f32_plan(100, 2, d, mr, h, attn_width=da).group
    passes = tsb.f32_tiled_passes(d, mr, group, da)
    assert [len(p) for p in passes] == [3 * group] * (da // group) + [mr]
    assert sorted(c for p in passes for c in p) == list(range(3 * da + mr))
    rng = np.random.default_rng(d + size)
    w1 = torch.from_numpy(rng.standard_normal((3 * da + mr, d)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((d, da + mr)).astype(np.float32))
    w1s, w2t = tsb._tiled_operands(w1, w2, d, mr, group, da)
    assert w1s.numel() == (3 * da + d) * d and torch.equal(w2t, w2.t())
    off = 0
    for cols in passes:
        p = max(len(cols), d) if cols[0] >= 3 * da else len(cols)
        for k0 in range(0, d, 32):
            run = w1s[off + k0 * p: off + (k0 + 32) * p].view(32, p)
            assert torch.equal(run[:, :len(cols)], w1[cols, k0:k0 + 32].t())
            assert not run[:, len(cols):].any()
        off += d * p
    assert off == w1s.numel()
    assert tsb._tiled_operands(w1, w2, d, mr, group, da)[0] is w1s  # kept
    other = tsb._tiled_operands(w1, w2, d, mr, group, group // 2)  # another Da
    assert other[0].numel() != w1s.numel()
    tsb.clear_weight_cache()


def test_val_hook_runs_the_sharded_ema(world):
    """The protocol val hook (``make_protocol_val_hook``, on the state's EMA
    through ``on_weights``) on a TP state in one process: the EMA's slices
    reach the shards, and the ADE/FDE equal the unsharded state's."""
    from lam_slide_tpu_torch.composites.testing import make_protocol_val_hook

    out = []
    for size in (1, 2):
        ss, _ = tiny_md17(world["inputs"])
        tx, _ = make_optimizer(TrainerConfig(**TRAINER), 1)
        state = tp.shard_train_state(create_train_state(ss.backbone, tx), size=size)
        with torch.no_grad():  # EMA away from the parameters, so the hook must read it
            for v in state.ema_params.values():
                v.mul_(0.9)
        hook = make_protocol_val_hook(ss, {"mix": [world["inputs"]["md17_batch"]]}, k=2,
                                      sampling_kwargs={"sampling_method": "euler",
                                                       "num_steps": 3})
        out.append(hook(state, 0))
    assert tp.sharded_names(ss.backbone)[0]
    for key, v in out[0].items():
        assert np.isfinite(v) and abs(out[1][key] - v) <= 1e-5 * abs(v), (key, out)
