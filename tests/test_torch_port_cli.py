"""The port's CLI and MD17 registry (``train/cli.py``,
``experiments/registry.py``) and its fp32 test protocol against the JAX
package, on the CPU.

* The counterpart of ``tests/test_train.py::test_cli_test_protocol_fp32_on_test_split``:
  smoke stage 1 -> stage 2 with ``--first-stage-run s1 --test`` and a bf16
  training DiT: the protocol runs on the fp32 rebuild, every floating
  tensor of it fp32, over the held-out test split, with ``k_chunk=1``, and
  ``test_metrics.json`` is finite; ``--test-only`` from the checkpoint
  alone reproduces it exactly; ``runs.json`` links s2 to s1 and its
  ``launch`` block has the JAX CLI's keys.
* ``--model-axis 2`` is refused, naming the tensor-parallelism item of
  ROADMAP.md; ``--fsdp``, ``--devices 2``, ``--multihost`` (two processes
  under a torchrun-style rendezvous) and ``--test-mesh`` run on the CPU and
  give the one-rank run's records, weights and test metrics; every
  experiment of the JAX registry builds.
* ``num_heads``, ``batch_size`` and ``dit_dtype`` reach the stage-2 config,
  loaders and DiT as in the JAX registry; stage 1's registry meta equals
  JAX's.
* fp32 protocol parity: JAX ``evaluate_md17`` on its registry's fp32
  ``test_model`` and the port's on the converted weights, fed the same
  initial noise, K=2, ``k_chunk=1``: ADE/FDE within 1e-4 relative; at the
  smoke width, and with the DiT widened to 2 x dh 128 (hidden 256,
  ``num_heads=2``: its temporal attention takes K5's branch).
"""

import ast
import dataclasses
import json
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.composites import md17 as jmd17
from lam_slide_tpu.composites import testing as jtesting
from lam_slide_tpu.experiments import registry as jreg
from lam_slide_tpu_torch import convert
from lam_slide_tpu_torch.composites import md17 as tmd17
from lam_slide_tpu_torch.composites import testing as ttesting
from lam_slide_tpu_torch.experiments import registry as treg
from lam_slide_tpu_torch.parallel import run_ranks
from lam_slide_tpu_torch.train.cli import main

from support_torch_parallel_ranks import cli_rank

ROOT = Path(__file__).resolve().parents[1]
PROTOCOL_RTOL = 1e-4


def _cli_runs(ws):
    """Smoke stage 1 (s1), then stage 2 (s2) on it with --test and a bf16
    training DiT, both on the CPU."""
    common = ["--smoke", "--workspace", ws, "--no-mesh", "--molecule", "aspirin",
              "--device", "cpu"]
    assert main(["--experiment", "md17_first_stage", "--run-id", "s1", "--epochs", "1",
                 *common]) == 0
    assert main(["--experiment", "md17_second_stage", "--run-id", "s2",
                 "--first-stage-run", "s1", "--epochs", "1", "--test",
                 "--exp-set", "dit_dtype=bfloat16", "--exp-set", "batch_size=16", *common]) == 0


def test_cli_test_protocol_fp32_on_test_split_and_test_only(tmp_path, monkeypatch):
    captured = []
    real = ttesting.evaluate_md17

    def spy(ss, loaders, **kw):
        captured.append((ss, loaders, kw))
        return real(ss, loaders, **kw)

    monkeypatch.setattr(ttesting, "evaluate_md17", spy)
    ws = str(tmp_path / "ws")
    _cli_runs(ws)
    runs = [c for c in captured if c[2].get("k_chunk") == 1]  # not the val hook's
    (ss, loaders, kw), = runs
    # the fp32 rebuild, not the bf16 training DiT
    assert ss.backbone.backbone.dtype == torch.float32
    for module in (ss.backbone, ss.first_stage):
        for name, t in module.state_dict().items():
            assert not t.is_floating_point() or t.dtype == torch.float32, name
    # the held-out chronological test split, K repeats one at a time
    assert [loader.dataset.mode for loader in loaders.values()] == ["test"]
    assert kw["k_chunk"] == 1 and kw["k"] == 2
    trained = json.load(open(tmp_path / "ws" / "s2" / "test_metrics.json"))
    assert set(trained) == {"test/aspirin/ade", "test/aspirin/fde"}
    assert all(np.isfinite(v) for v in trained.values())

    # --test-only from the checkpoint alone: the experiment, molecule, smoke
    # flag, overrides and stage lineage come back from the run registry
    (tmp_path / "ws" / "s2" / "test_metrics.json").unlink()
    assert main(["--workspace", ws, "--run-id", "s2", "--test-only", "--test-ckpt", "last",
                 "--device", "cpu"]) == 0
    assert json.load(open(tmp_path / "ws" / "s2" / "test_metrics.json")) == trained
    assert captured[-1][0].backbone.backbone.dtype == torch.float32
    assert captured[-1][2]["k_chunk"] == 1

    registry = json.load(open(tmp_path / "ws" / "runs.json"))
    assert registry["s2"]["config"]["first_stage_run"] == "s1"
    assert registry["s2"]["config"]["launch"]["first_stage_run"] == "s1"
    assert registry["s1"]["config"]["stage"] == 1 and registry["s2"]["config"]["stage"] == 2
    assert set(registry["s2"]["config"]["launch"]) == _jax_launch_keys()
    records = [json.loads(line) for line in open(tmp_path / "ws" / "s2" / "metrics.jsonl")]
    assert [r["split"] for r in records] == ["train", "val/aspirin", "hook/val_sample"]
    assert all(np.isfinite(v) for r in records for v in r.values() if isinstance(v, float))


def _jax_launch_keys():
    """The keys of the ``launch`` dict literal the JAX CLI registers."""
    tree = ast.parse((ROOT / "lam_slide_tpu" / "train" / "cli.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) and key.value == "launch":
                    return {k.value for k in value.keys}
    raise AssertionError("no launch block in the JAX CLI")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _records(path):
    return [json.loads(line) for line in open(path) if '"train"' in line]


@pytest.fixture(scope="module")
def one_rank_s1(tmp_path_factory):
    """A plain one-rank smoke stage 1 (one epoch): the reference run."""
    ws = str(tmp_path_factory.mktemp("ws1"))
    assert main(["--experiment", "md17_first_stage", *S1, "--workspace", ws, "--run-id", "s1",
                 "--no-mesh"]) == 0
    return ws


S1 = ["--smoke", "--device", "cpu", "--molecule", "aspirin", "--epochs", "1"]


def _same_run(ws, run, ref_ws, rtol=1e-5):
    """The run's train records and weights equal the one-rank run's: the
    data-parallel step is the one-rank step."""
    got, want = _records(Path(ws) / run / "metrics.jsonl"), _records(Path(ref_ws) / "s1" /
                                                                     "metrics.jsonl")
    assert len(got) == len(want) == 1
    for k, v in want[0].items():
        if k.startswith("train/"):
            assert abs(got[0][k] - v) <= rtol * max(abs(v), 1e-30), k
    a = treg.load_checkpoint_raw(str(Path(ws) / run), "last")["params"]
    b = treg.load_checkpoint_raw(str(Path(ref_ws) / "s1"), "last")["params"]
    model = treg.md17_first_stage(smoke=True, device="cpu").model
    model.load_state_dict(a)  # whole tensors: it loads in a one-rank run
    for k, w in b.items():
        if w.is_floating_point():
            assert (a[k] - w).abs().max() <= 1e-4 * max(w.abs().max(), 1e-30), k


@pytest.mark.parametrize("flags", [["--model-axis", "2"], ["--fsdp"], ["--devices", "2"],
                                   ["--multihost"], ["--test-mesh"]])
def test_multi_device_flags_are_refused(flags, tmp_path, one_rank_s1):
    """Named for the refusals it once pinned: every multi-device flag now
    runs on the CPU. ``--model-axis 2`` with ``--devices 2`` (two gloo ranks
    on a data 1 x model 2 mesh: both ranks train on the whole batch; stage
    1 has no DiT block to split, so every parameter stays whole), ``--fsdp``
    (a one-rank group) and ``--devices 2`` (two spawned gloo ranks) equal
    the one-rank run, with a checkpoint that loads in one. ``--multihost`` runs as two processes
    joined through torchrun's environment variables, each loading its slice
    of every batch: both finish, rank 0 alone logs, and its records are
    finite (each process draws its own augmentation stream, so they are not
    the one-rank run's). ``--test-mesh`` with ``--devices 2 --test-only``
    shards the protocol over the ranks and gives the one-rank metrics."""
    ws = str(tmp_path)
    if flags[0] == "--model-axis":
        assert main(["--experiment", "md17_first_stage", *S1, "--workspace", ws, "--run-id", "t",
                     "--devices", "2", *flags]) == 0
        _same_run(ws, "t", one_rank_s1)
    elif flags[0] == "--fsdp":
        assert main(["--experiment", "md17_first_stage", *S1, "--workspace", ws, "--run-id", "f",
                     *flags]) == 0
        _same_run(ws, "f", one_rank_s1)
    elif flags[0] == "--devices":
        assert main(["--experiment", "md17_first_stage", *S1, "--workspace", ws, "--run-id", "d",
                     *flags]) == 0
        _same_run(ws, "d", one_rank_s1)
    elif flags[0] == "--multihost":
        env = {"WORLD_SIZE": 2, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": _free_port()}
        argv = ["--experiment", "md17_first_stage", *S1, "--workspace", ws, "--run-id", "m",
                *flags]
        outs = run_ranks(cli_rank, 2, args=(argv, env), init=False, timeout_s=300.0)
        assert [o["code"] for o in outs] == [0, 0]
        for r, o in enumerate(outs):
            assert f"multihost: process {r}/2" in o["stdout"]
        assert "done:" in outs[0]["stdout"] and "done:" not in outs[1]["stdout"]
        records = _records(Path(ws) / "m" / "metrics.jsonl")
        assert len(records) == 1 and all(np.isfinite(v) for v in records[0].values()
                                         if isinstance(v, float))
    else:
        ws = one_rank_s1  # stage 2 on the reference stage 1, then its test pass
        assert main(["--experiment", "md17_second_stage", "--first-stage-run", "s1", *S1,
                     "--workspace", ws, "--run-id", "s2m", "--no-mesh",
                     "--set", "val_every_n_epochs=2"]) == 0  # no val pass: only its test
        test_only = ["--workspace", ws, "--run-id", "s2m", "--test-only", "--device", "cpu"]
        assert main([*test_only, "--no-mesh"]) == 0
        want = json.load(open(Path(ws) / "s2m" / "test_metrics.json"))
        assert main([*test_only, "--devices", "2", *flags]) == 0
        got = json.load(open(Path(ws) / "s2m" / "test_metrics.json"))
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-5 * abs(v), k


# the JAX registry's experiments that the port's registry refused (raising
# NotImplementedError) until the pedestrian and NBA workloads were ported
FORMERLY_UNPORTED = ("nba_first_stage", "nba_second_stage", "pedestrian_first_stage",
                     "pedestrian_second_stage")


@pytest.mark.parametrize("name", FORMERLY_UNPORTED)
def test_unported_experiments_raise(name):
    """No experiment of the JAX registry raises any more: each of those the
    port once refused builds (its smoke run, on the CPU), and an unknown
    name raises KeyError."""
    run = treg.build_experiment(name, smoke=True, device="cpu")
    assert run.name == name and run.meta["domain"] == name.split("_")[0]
    with pytest.raises(KeyError, match="unknown experiment"):
        treg.build_experiment(name + "_x", smoke=True, device="cpu")


def test_registry_names_cover_jax():
    assert set(treg.EXPERIMENTS) == set(jreg.EXPERIMENTS)


def test_overrides_reach_the_config_as_in_jax():
    """num_heads, batch_size and dit_dtype (as the string --exp-set gives)
    on the smoke stage 2, against the JAX registry's run; num_heads also at
    full width (the 2 x dh 128 split), where JAX needs a stage-1 run id."""
    kw = dict(smoke=True, num_heads=2, batch_size=3, dit_dtype="bfloat16", molecule="aspirin")
    jrun = jreg.md17_second_stage(**kw)
    run = treg.md17_second_stage(**kw, device="cpu")
    assert run.config.num_heads == jrun.meta["config"]["num_heads"] == 2
    assert run.model.backbone.num_heads == 2
    assert run.train_loader.batch_size == jrun.train_loader.batch_size == 3
    for split in ("val_loaders", "test_loaders"):
        assert {m: l.batch_size for m, l in getattr(run, split).items()} == {
            m: l.batch_size for m, l in getattr(jrun, split).items()}
    assert run.model.backbone.dtype == torch.bfloat16
    assert jrun.model.backbone.dit.dtype == jnp.bfloat16
    assert run.test_model.backbone.backbone.dtype == torch.float32
    assert jrun.test_model.backbone.dit.dtype == jnp.float32
    assert run.trainer_cfg == treg.TrainerConfig(**dataclasses.asdict(jrun.trainer_cfg))
    assert set(run.meta) == set(jrun.meta) and run.meta["stage"] == jrun.meta["stage"]

    s1 = treg.md17_first_stage(smoke=True, device="cpu")
    full = treg.md17_second_stage(first_stage=s1, num_heads=2, molecule="aspirin",
                                  device="cpu")
    assert full.config.num_heads == 2 and full.config.hidden_size == 256
    assert full.model.backbone.hidden_size // full.model.backbone.num_heads == 128
    assert full.train_loader.batch_size == 64 and full.trainer_cfg.limit_val_batches == 5
    assert full.model.backbone.dtype == torch.bfloat16


def test_first_stage_registry_matches_jax():
    """Stage 1's TrainerConfig (monitor pos_loss, val cadence) and its
    registry meta (config, stage, domain) equal the JAX registry's, so a
    stage-1 run's lineage record reads the same from both packages."""
    jrun = jreg.md17_first_stage(smoke=True, molecule="aspirin")
    run = treg.md17_first_stage(smoke=True, molecule="aspirin", device="cpu")
    assert dataclasses.asdict(run.trainer_cfg) == dataclasses.asdict(jrun.trainer_cfg)
    jmeta = json.loads(json.dumps(jrun.meta))
    assert {k: v for k, v in run.meta.items() if k != "config"} == {
        k: v for k, v in jmeta.items() if k != "config"}
    # every field of the port's config, as JAX records it (JAX's config also
    # has ``shift``, which the port's first stage does not take)
    assert run.meta["config"] == {k: jmeta["config"][k] for k in run.meta["config"]}
    full = treg.md17_first_stage(molecule="aspirin", device="cpu")
    assert (full.trainer_cfg.monitor, full.trainer_cfg.val_every_n_epochs) == ("pos_loss", 25)


def test_second_stage_from_a_run_id_prefers_the_ema(tmp_path):
    """load_first_stage_variables reads the stage-1 checkpoint of a run id
    and prefers its EMA; load_checkpoint_raw falls back from best to last
    with a warning."""
    ws = str(tmp_path / "ws")
    assert main(["--experiment", "md17_first_stage", "--smoke", "--workspace", ws,
                 "--run-id", "s1", "--epochs", "1", "--molecule", "aspirin", "--device", "cpu",
                 "--set", "val_every_n_epochs=5"]) == 0
    raw = treg.load_checkpoint_raw(str(tmp_path / "ws" / "s1"), "best")  # none: val never ran
    state, cfg = treg.load_first_stage_variables(ws, "s1")
    assert cfg["stage"] == 1
    for k, v in raw["ema_params"].items():
        assert torch.equal(state[k], v) and not torch.equal(v, raw["params"][k])
    run = treg.md17_second_stage(smoke=True, first_stage_run="s1", molecule="aspirin",
                                 workspace=ws, device="cpu")
    for k, v in run.second_stage.first_stage.state_dict().items():
        assert torch.equal(v, state[k]), k


# ---------------------------------------------------------------- fp32 protocol parity

@pytest.mark.parametrize("width", ["smoke", "2x128"])
def test_fp32_protocol_matches_jax(monkeypatch, width):
    """The JAX registry's smoke stage 2 with a bf16 training DiT and its fp32
    test_model; the port's test_model loaded with the same (converted)
    weights. Both run evaluate_md17 over the first test batch, K=2,
    k_chunk=1, fed the same initial noise. At "2x128" both registries take
    ``num_heads=2`` and both fp32 test models are rebuilt at hidden 256 on
    the same frozen stage 1, with the JAX init's weights."""
    heads = {"num_heads": 2} if width == "2x128" else {}
    jrun = jreg.md17_second_stage(smoke=True, molecule="aspirin", dit_dtype="bfloat16", **heads)
    run = treg.md17_second_stage(smoke=True, molecule="aspirin", dit_dtype="bfloat16",
                                 device="cpu", **heads)
    params = jax.tree.map(np.asarray, jrun.variables["params"])
    fs_vars = jax.tree.map(np.asarray, jrun.variables["constants"]["first_stage"])
    jss, ss = jrun.test_model, run.test_model
    batch = next(iter(run.test_loaders["aspirin"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if width == "2x128":
        jcfg = dataclasses.replace(jmd17.MD17SecondStageConfig(**jrun.meta["config"]),
                                   hidden_size=256)
        jss = jmd17.build_md17_second_stage(jcfg, jss.first_stage, fs_vars,
                                            dtype=jnp.float32)
        x1, mk = jss.prepare_batch(fs_vars, jbatch)
        params = jax.tree.map(np.asarray, jax.jit(jss.backbone.init)(
            jax.random.PRNGKey(1), x1, jnp.zeros((x1.shape[0],)), mk["x_cond"],
            mk["x_cond_mask"], mk.get("y_class"))["params"])
        ss = tmd17.build_md17_second_stage(dataclasses.replace(run.config, hidden_size=256),
                                           ss.first_stage, device="cpu")
        assert ss.backbone.backbone.hidden_size // ss.backbone.backbone.num_heads == 128
    ss.backbone.load_state_dict(convert.class_cond_dit_state_dict_from_jax(params))
    ss.first_stage.load_state_dict(convert.first_stage_state_dict_from_jax(
        fs_vars["params"], fs_vars["constants"]))
    loaders = {"aspirin": [batch]}
    x1, _ = jax.jit(jss.prepare_batch)(fs_vars, jbatch)
    noise = np.random.default_rng(7).standard_normal(x1.shape).astype(np.float32)

    def jax_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise, dtype)

    def torch_randn(shape, generator=None, device=None, dtype=None):
        return torch.from_numpy(np.broadcast_to(noise, tuple(shape)).copy()).to(device, dtype)

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(torch, "randn", torch_randn)
    scale = treg.MD17_SCALES["aspirin"]
    want = jtesting.evaluate_md17(jss, params, fs_vars, loaders, scale=scale, k=2, k_chunk=1)
    got = ttesting.evaluate_md17(ss, loaders, scale=scale, k=2, k_chunk=1)
    assert set(got) == set(want) == {"test/aspirin/ade", "test/aspirin/fde"}
    for k, v in want.items():
        assert abs(got[k] - v) <= PROTOCOL_RTOL * abs(v), (k, got[k], v)
