"""The port's training loop (``train/trainer.py``, ``train/checkpoint.py``,
``train/steps.py``, ``train/sinks.py``) against the JAX package, on the CPU.

Mirrors ``tests/test_train.py`` on a small torch MLP: the loss falls, the
EMA lags, the eval step uses the EMA (or the parameters when the state
keeps none, ``ema_decay=None``); the checkpoint round trip and the run
registry (whose file the JAX package reads back); ``fit`` with val, hooks,
checkpoints and resume; a fit interrupted after an epoch and resumed ends
bit for bit where a straight fit ends; a failed fit logs an ``error``
record and saves ``last``; ``grad_accum`` through the Trainer; the
``MetricLogger``'s records and the sinks.

Parity with JAX: both Trainers fit the smoke MD17 stage 1 from the same
weights (converted) over the same batches, with the decoder's query
dropout at 0 (torch and JAX draw different masks, as
``tests/test_torch_port_md17_train.py`` explains): the per-epoch train and
val means agree within 1e-4 relative, ``metrics.jsonl`` holds the same
split/key sequence, ``meta.json`` the same fields and values, and best/last
are promoted at the same epochs.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.composites import md17 as jmd17
from lam_slide_tpu.train import checkpoint as jckpt
from lam_slide_tpu.train.trainer import MetricLogger as JMetricLogger
from lam_slide_tpu.train.trainer import Trainer as JTrainer
from lam_slide_tpu.train.trainer import TrainerConfig as JTrainerConfig
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.experiments import registry as treg
from lam_slide_tpu_torch.train import checkpoint as tckpt
from lam_slide_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from lam_slide_tpu_torch.train.optim import AdamW
from lam_slide_tpu_torch.train.sinks import CallableSink, TensorBoardSink, WandbSink
from lam_slide_tpu_torch.train.trainer import MetricLogger, Trainer, TrainerConfig

MEAN_RTOL = 1e-4


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(8, 32), torch.nn.ReLU(), torch.nn.Linear(32, 1))


def _loss_fn(model, batch, generator, train):
    loss = torch.mean((model(batch["x"]) - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = x @ rng.standard_normal((8, 1)).astype(np.float32)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _setup(ema=True, ema_decay=0.99):
    model = _mlp()
    tx = AdamW(lambda count: 1e-2, weight_decay=1e-4)
    state = create_train_state(model, tx, ema=ema)
    return state, make_train_step(_loss_fn, tx, ema_decay=ema_decay), _batch()


class _Batches:
    """A loader over fixed batches, the same every epoch; ``fail_at``
    raises at the start of that epoch (0-based)."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at, self.epoch = batches, fail_at, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        epoch, self.epoch = self.epoch, self.epoch + 1
        if epoch == self.fail_at:
            raise RuntimeError("boom")
        yield from self.batches


def _records(run_dir):
    return [json.loads(line) for line in open(run_dir / "metrics.jsonl")]


# ---------------------------------------------------------------- steps

def test_loss_decreases():
    state, step, batch = _setup()
    first = None
    for _ in range(60):
        state, metrics = step(state, batch, 42)
        first = float(metrics["loss"]) if first is None else first
    assert float(metrics["loss"]) < first * 0.1
    assert state.step == 60


def test_ema_lags_params():
    state, step, batch = _setup()
    init = {k: v.detach().clone() for k, v in state.params.items()}
    for _ in range(5):
        state, _ = step(state, batch, 0)
    norm = lambda tree: torch.sqrt(sum(((tree[k] - init[k]) ** 2).sum() for k in init))
    assert 0 < norm(state.ema_params) < norm({k: v.detach() for k, v in state.params.items()})


def test_eval_step_uses_the_ema_or_the_params_without_one():
    """After 10 steps at decay 0.99 the EMA is far behind, so its loss
    differs from the parameters'; a state built with ``ema=False`` and
    stepped with ``ema_decay=None`` keeps no EMA, and its eval step runs on
    the parameters (JAX steps.py:105-106, 155)."""
    state, step, batch = _setup()
    for _ in range(10):
        state, _ = step(state, batch, 0)
    m_ema = make_eval_step(_loss_fn)(state, batch, 0)
    m_raw = make_eval_step(_loss_fn, use_ema=False)(state, batch, 0)
    assert float(m_ema["loss"]) != float(m_raw["loss"])

    state, step, batch = _setup(ema=False, ema_decay=None)
    for _ in range(10):
        state, _ = step(state, batch, 0)
    assert state.ema_params is None
    want = _loss_fn(state.model, batch, None, False)[0].detach()
    assert float(make_eval_step(_loss_fn)(state, batch, 0)["loss"]) == want.item()


# ---------------------------------------------------------------- checkpoints

def _fresh_state():
    tx = AdamW(lambda count: 1e-2, weight_decay=1e-4)
    model = _mlp()
    for p in model.parameters():
        torch.nn.init.zeros_(p)
    return create_train_state(model, tx)


def test_checkpoint_roundtrip(tmp_path):
    state, step, batch = _setup()
    for _ in range(3):
        state, metrics = step(state, batch, 0)
    mgr = tckpt.CheckpointManager(str(tmp_path / "run1"), monitor="loss")
    mgr.save(state, {k: float(v) for k, v in metrics.items()})
    assert mgr.has("last") and mgr.has("best")
    saved = {k: v.detach().clone() for k, v in state.params.items()}
    # a worse metric: best is not replaced
    state, metrics = step(state, batch, 0)
    mgr.save(state, {"loss": float(metrics["loss"]) + 100.0})
    best = mgr.restore(_fresh_state(), "best")
    assert best.step == 3 and best.opt_state.count == 3
    for k, v in best.params.items():
        assert torch.equal(v, saved[k])
    last = mgr.restore(_fresh_state(), "last")
    assert last.step == 4
    for k, v in last.params.items():
        assert torch.equal(v, state.params[k]) and torch.equal(last.ema_params[k],
                                                               state.ema_params[k])
    meta = json.load(open(tmp_path / "run1" / "checkpoints" / "meta.json"))
    assert meta == {"monitor": "loss", "mode": "min", "best_metric": mgr.best_metric,
                    "last_step": 4}
    # no temporary file is left behind by the atomic writes
    assert sorted(p.name for p in (tmp_path / "run1" / "checkpoints").iterdir()) == [
        "best.pt", "last.pt", "meta.json"]


def test_run_registry_reads_the_same_in_both_packages(tmp_path):
    ws = str(tmp_path / "ws")
    tckpt.register_run(ws, "abc123", str(tmp_path / "run1"), {"lr": 1e-3})
    jckpt.register_run(ws, "def456", str(tmp_path / "run2"), {"lr": 2e-3})
    for resolve in (tckpt.resolve_run, jckpt.resolve_run):
        assert resolve(ws, "abc123")["config"]["lr"] == 1e-3
        assert resolve(ws, "def456")["run_dir"] == str(tmp_path / "run2")
        with pytest.raises(KeyError):
            resolve(ws, "missing")
    assert set(tckpt.resolve_run(ws, "abc123")) == set(jckpt.resolve_run(ws, "def456")) == {
        "run_dir", "config", "time"}


# ---------------------------------------------------------------- the loop

def test_trainer_fit_val_ckpt_resume(tmp_path):
    """fit with val and an eval hook, checkpoints, resume (which appends to
    the metric stream), and a fresh fit into the same run dir (which
    truncates it)."""
    batch = _batch()
    hook_calls = []
    cfg = TrainerConfig(max_epochs=3, lr=1e-2, monitor="loss", limit_val_batches=1)
    trainer = Trainer(cfg, _loss_fn, str(tmp_path / "run"), quiet=True,
                      eval_fns={"probe": lambda s, e: hook_calls.append(e) or {"x": 1.0}})
    state = trainer.fit(_mlp(), _Batches([batch, batch]), {"val": _Batches([batch, batch])})
    assert state.step == 6 and hook_calls == [0, 1, 2]
    assert (tmp_path / "run" / "checkpoints" / "best.pt").exists()
    n_first = len(_records(tmp_path / "run"))
    assert [r["split"] for r in _records(tmp_path / "run")] == [
        "train", "val/val", "hook/probe"] * 3

    cfg2 = TrainerConfig(max_epochs=5, lr=1e-2, monitor="loss")
    state2 = Trainer(cfg2, _loss_fn, str(tmp_path / "run"), quiet=True).fit(
        _mlp(), _Batches([batch, batch]), {"val": _Batches([batch])}, resume=True)
    assert state2.step == 10
    assert len(_records(tmp_path / "run")) > n_first

    Trainer(cfg, _loss_fn, str(tmp_path / "run"), quiet=True).fit(
        _mlp(), _Batches([batch, batch]), {"val": _Batches([batch])})
    epochs = [r["epoch"] for r in _records(tmp_path / "run") if r["split"] == "train"]
    assert epochs == [0, 1, 2]


def _stage1_run(dropout_query=0.1):
    run = treg.md17_first_stage(smoke=True, device="cpu")
    run.model.decoder.query_mlp[0].rate = dropout_query
    loader = run.train_loader
    batches = [b for _, b in zip(range(2), loader)]
    val = {m: [next(iter(v))] for m, v in run.val_loaders.items()}
    return run, batches, val


@pytest.fixture
def one_thread():
    """One CPU thread: the multithreaded backward of the atom embedding's
    gather (index_put_ with accumulation) sums in a varying order, so two
    straight fits differ in the last bits with more threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_interrupted_then_resumed_fit_equals_a_straight_fit_bit_for_bit(tmp_path, one_thread):
    """The smoke MD17 stage 1 (decoder query dropout on, drawn from each
    step's generator): a fit whose loader fails at the start of its second
    epoch saves 'last' there; resuming it runs the second epoch to the same
    parameters, EMA, optimizer state and metrics as two straight epochs, bit
    for bit. The step seeds fold in the step counter, which the checkpoint
    restores."""
    cfg = dict(max_epochs=2, lr=4e-3, monitor="pos_loss", seed=3)
    straight, batches, val = _stage1_run()
    s_state = Trainer(TrainerConfig(**cfg), straight.loss_fn, str(tmp_path / "straight"),
                      quiet=True).fit(straight.model, _Batches(batches), val)

    first, _, _ = _stage1_run()
    with pytest.raises(RuntimeError, match="boom"):
        Trainer(TrainerConfig(**cfg), first.loss_fn, str(tmp_path / "resumed"), quiet=True).fit(
            first.model, _Batches(batches, fail_at=1), val)
    second, _, _ = _stage1_run()
    r_state = Trainer(TrainerConfig(**cfg), second.loss_fn, str(tmp_path / "resumed"),
                      quiet=True).fit(second.model, _Batches(batches), val, resume=True)
    assert r_state.step == s_state.step == 2 * len(batches)
    assert r_state.opt_state.count == s_state.opt_state.count
    for name, p in s_state.model.state_dict().items():
        assert torch.equal(r_state.model.state_dict()[name], p), name
    for group in ("ema_params",):
        for name, p in getattr(s_state, group).items():
            assert torch.equal(getattr(r_state, group)[name], p), name
    for name in s_state.opt_state.mu:
        assert torch.equal(r_state.opt_state.mu[name], s_state.opt_state.mu[name])
        assert torch.equal(r_state.opt_state.nu[name], s_state.opt_state.nu[name])
    want = [r for r in _records(tmp_path / "straight") if r["epoch"] == 1]
    got = [r for r in _records(tmp_path / "resumed") if r.get("epoch") == 1]
    strip = lambda r: {k: v for k, v in r.items() if k not in ("time_s", "step_ms")}
    assert [strip(r) for r in got] == [strip(r) for r in want]


def test_fit_failure_logs_and_saves_last(tmp_path):
    """task_wrapper semantics: a crashing loader still leaves an error
    record in the metric stream and a restorable 'last' checkpoint."""
    batch = _batch()
    cfg = TrainerConfig(max_epochs=5, lr=1e-2, val_every_n_epochs=100)
    with pytest.raises(RuntimeError, match="boom"):
        Trainer(cfg, _loss_fn, str(tmp_path / "run"), quiet=True).fit(
            _mlp(), _Batches([batch, batch], fail_at=1))
    errors = [r for r in _records(tmp_path / "run") if r.get("split") == "error"]
    assert errors and "boom" in errors[0]["error"] and errors[0]["step"] == 2
    mgr = tckpt.CheckpointManager(str(tmp_path / "run"))
    assert mgr.has("last") and mgr.restore(_fresh_state()).step == 2


def test_grad_accum_through_trainer(tmp_path):
    batch = _batch()
    cfg = TrainerConfig(max_epochs=20, lr=1e-2, grad_accum=4, val_every_n_epochs=100)
    Trainer(cfg, _loss_fn, str(tmp_path / "run"), quiet=True).fit(
        _mlp(), _Batches([batch] * 3))
    losses = [r["train/loss"] for r in _records(tmp_path / "run") if r["split"] == "train"]
    assert losses[-1] < losses[0] * 0.2


def test_fit_without_an_ema(tmp_path):
    """``ema_decay=None``: no EMA is kept, validation and the checkpoints
    run on the parameters, and a checkpoint's ema_params is None."""
    batch = _batch()
    cfg = TrainerConfig(max_epochs=2, lr=1e-2, ema_decay=None)
    state = Trainer(cfg, _loss_fn, str(tmp_path / "run"), quiet=True).fit(
        _mlp(), _Batches([batch]), {"val": _Batches([batch])})
    assert state.ema_params is None
    val = [r for r in _records(tmp_path / "run") if r["split"] == "val/val"][-1]
    want = _loss_fn(state.model, batch, None, False)[0].item()
    assert val["val/val/loss"] == pytest.approx(want, rel=1e-6)
    raw = treg.load_checkpoint_raw(str(tmp_path / "run"), "last")
    assert raw["ema_params"] is None and raw["step"] == 2


def test_fsdp_raises(tmp_path):
    """Named for the refusal it once pinned: ``fsdp=True`` now runs. Over a
    mesh (a one-rank gloo group here) the fit shards the model with FSDP2
    and takes the plain fit's steps, and its checkpoint holds whole tensors;
    without a mesh there is nothing to shard, as in JAX, and the fit is the
    plain one."""
    import torch.distributed as dist

    from lam_slide_tpu_torch.parallel import MeshSpec, init_distributed, make_mesh
    from lam_slide_tpu_torch.parallel.fsdp import uses_fsdp

    cfg = dict(fsdp=True, max_epochs=2, lr=1e-2)
    plain = Trainer(TrainerConfig(**cfg), _loss_fn, str(tmp_path / "plain"), quiet=True).fit(
        _mlp(), _Batches([_batch()]))
    assert not uses_fsdp(plain.model)
    init_distributed("gloo", rank=0, world_size=1,
                     init_method=f"file://{tmp_path}/rendezvous")
    try:
        sharded = Trainer(TrainerConfig(**cfg), _loss_fn, str(tmp_path / "fsdp"), quiet=True,
                          mesh=make_mesh(MeshSpec())).fit(_mlp(), _Batches([_batch()]))
        assert uses_fsdp(sharded.model)
    finally:
        dist.destroy_process_group()
    want = tckpt.CheckpointManager(str(tmp_path / "plain"))
    got = torch.load(tckpt.CheckpointManager(str(tmp_path / "fsdp")).path("last"),
                     weights_only=True)
    ref = torch.load(want.path("last"), weights_only=True)
    assert got["step"] == ref["step"] == 2
    for tree in ("params", "ema_params"):
        for k, v in ref[tree].items():
            assert type(got[tree][k]) is torch.Tensor
            torch.testing.assert_close(got[tree][k], v, rtol=1e-5, atol=1e-6)


def test_trainer_config_has_jax_fields():
    assert [f.name for f in dataclasses.fields(TrainerConfig)] == [
        f.name for f in dataclasses.fields(JTrainerConfig)]
    assert dataclasses.asdict(TrainerConfig()) == dataclasses.asdict(JTrainerConfig())


# ---------------------------------------------------------------- logger, sinks

def test_metric_logger_records_match_jax(tmp_path, capsys):
    """The same records (ints, floats, device scalars: numpy/jnp on one
    side, torch on the other, strings) give the same JSONL lines, the same
    stdout, and the same backup/reset behaviour."""
    recs = [({"epoch": 0, "split": "train", "train/loss": np.float32(0.5), "n": 3},
             {"epoch": 0, "split": "train", "train/loss": torch.tensor(0.5), "n": 3}),
            ({"split": "error", "error": "RuntimeError: x", "step": 7},) * 2]
    outs = []
    for cls, side in ((JMetricLogger, 0), (MetricLogger, 1)):
        logger = cls(str(tmp_path / cls.__module__))
        for pair in recs:
            logger.log(pair[side])
        assert logger.backup().endswith("metrics.jsonl.bak")
        logger.close()
        outs.append((open(tmp_path / cls.__module__ / "metrics.jsonl").read(),
                     capsys.readouterr().out))
    assert outs[0] == outs[1]


def test_sinks(tmp_path, monkeypatch):
    seen, hparams = [], []
    logger = MetricLogger(str(tmp_path), quiet=True,
                          sinks=[CallableSink(seen.append, hparams.append)])
    logger.log_hparams({"params": 3})
    logger.log({"epoch": 1, "split": "train", "train/loss": torch.tensor(2.0)})
    logger.close()
    assert hparams == [{"params": 3}] and seen == [
        {"epoch": 1.0, "split": "train", "train/loss": 2.0}]
    tb = TensorBoardSink(str(tmp_path / "tb"))
    tb.log({"epoch": 0, "split": "train", "train/loss": 1.0})
    tb.close()
    assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "tb").iterdir())
    monkeypatch.setitem(sys.modules, "wandb", None)  # a machine without wandb
    with pytest.raises(ImportError, match="wandb"):
        WandbSink(project="p")


# ---------------------------------------------------------------- parity with JAX

def _jax_stage1(run):
    jcfg = jmd17.MD17FirstStageConfig(**dataclasses.asdict(run.config))
    jmodel = jmd17.build_md17_first_stage(jcfg)
    return jmodel, jcfg


def test_md17_stage1_fit_matches_jax(tmp_path):
    """Both Trainers fit the smoke MD17 stage 1 (the registry's monitor and
    EMA 0.999, val every epoch, lr 4e-3 so that the val loss moves) for four
    epochs from the same weights over the same two train batches and one val
    batch per molecule, query dropout at 0."""
    run, batches, val = _stage1_run(dropout_query=0.0)
    run = dataclasses.replace(run, config=dataclasses.replace(run.config, dropout_query=0.0))
    jmodel, jcfg = _jax_stage1(run)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batches[0].items()}))
    run.model.load_state_dict(convert.first_stage_state_dict_from_jax(
        variables["params"], variables["constants"]))
    kw = dict(max_epochs=4, lr=4e-3, monitor="pos_loss", val_every_n_epochs=1, seed=0)
    metas = {"jax": [], "port": []}

    def meta_probe(key, run_dir):
        def hook(state, epoch):
            path = run_dir / "checkpoints" / "meta.json"
            metas[key].append(json.load(open(path)) if path.exists() else None)
            return {}
        return hook

    JTrainer(JTrainerConfig(**kw), jmd17.make_md17_first_stage_loss(jmodel, jcfg),
             str(tmp_path / "jax"), quiet=True,
             eval_fns={"meta": meta_probe("jax", tmp_path / "jax")}).fit(
        variables, _Batches(batches), {m: _Batches(b) for m, b in val.items()})
    Trainer(TrainerConfig(**kw), run.loss_fn, str(tmp_path / "port"), quiet=True,
            eval_fns={"meta": meta_probe("port", tmp_path / "port")}).fit(
        run.model, _Batches(batches), {m: _Batches(b) for m, b in val.items()})

    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [(r["split"], sorted(r)) for r in got] == [(r["split"], sorted(r)) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k == "train/lr":  # optax's fp32 schedule against the port's fp64 one
                assert abs(g[k] - v) <= 1e-5 * abs(v)
            elif k.startswith(("train/", "val/")):
                assert abs(g[k] - v) <= MEAN_RTOL * abs(v), (w["split"], w["epoch"], k)
            elif k not in ("time_s", "step_ms"):
                assert g[k] == v, k
    jmeta = json.load(open(tmp_path / "jax" / "checkpoints" / "meta.json"))
    tmeta = json.load(open(tmp_path / "port" / "checkpoints" / "meta.json"))
    metas["jax"].append(jmeta)
    metas["port"].append(tmeta)
    for m_j, m_t in zip(*metas.values()):  # before each val epoch's save, and at the end
        assert (m_j is None) == (m_t is None)
        if m_j is not None:
            assert set(m_t) == set(m_j)
            assert {k: v for k, v in m_t.items() if k != "best_metric"} == {
                k: v for k, v in m_j.items() if k != "best_metric"}
            assert abs(m_t["best_metric"] - m_j["best_metric"]) <= MEAN_RTOL * m_j["best_metric"]
    best_steps = [m["best_step"] for m in metas["port"] if m and "best_step" in m]
    assert best_steps, "no epoch promoted 'best': a vacuous comparison"


# ---------------------------------------------------------------- utils

def test_utils(tmp_path, capsys):
    """tree_to_f32 casts the floating tensors of a nested state dict and
    leaves the rest; log_once prints a message once; StepTimer derives step
    time and throughput from epoch times; trace writes a Chrome trace."""
    from lam_slide_tpu_torch.utils.logging import log_once
    from lam_slide_tpu_torch.utils.profiling import StepTimer, trace
    from lam_slide_tpu_torch.utils.trees import tree_to_f32

    tree = {"a": torch.ones(2, dtype=torch.bfloat16), "b": {"c": torch.arange(3)}, "d": None}
    out = tree_to_f32(tree)
    assert out["a"].dtype == torch.float32 and out["b"]["c"].dtype == torch.int64
    assert out["d"] is None and tree_to_f32(None) is None
    log_once("port-utils-test")
    log_once("port-utils-test")
    assert capsys.readouterr().out == "port-utils-test\n"
    timer = StepTimer()
    timer.record_epoch(2.0, 4)
    assert timer.mean_step_s == 0.5 and timer.throughput(16) == 32.0
    with trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
