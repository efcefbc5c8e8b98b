"""The pedestrian and NBA workloads through the port's CLI on the CPU, the
counterpart of ``lam_slide_tpu/train/cli.py``'s min-over-K test protocol
(``_run_test_protocol``, cli.py:308-313).

* ``--smoke`` stage 1 -> stage 2 ``--first-stage-run s1 --test`` for both
  workloads: both calls return 0; the test pass runs ``evaluate_min_k`` on
  the fp32 rebuild (every floating tensor fp32) over the test split (the
  registry's val loaders, the reference's test-as-val), with
  ``num_runs = min(num_runs, K)``, ``k_chunk=1`` and the config's
  ``post_process``; ``test_metrics.json`` has the keys JAX's protocol gives
  the JAX registry's loaders and config, finite; ``runs.json`` records the
  launch with the JAX CLI's keys and the scene, and links stage 2 to
  stage 1; the metric streams are complete and finite.
* ``--scene rebound``: the NBA runs train on the rebound scene, and
  ``--test-only`` from the checkpoint recovers the scene (with the
  experiment, the smoke flag and the stage lineage) from the run registry.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lam_slide_tpu.experiments import registry as jreg
from lam_slide_tpu_torch.composites import testing as ttesting
from lam_slide_tpu_torch.train.cli import main

ROOT = Path(__file__).resolve().parents[1]


def _jax_launch_keys():
    """The keys of the ``launch`` dict literal the JAX CLI registers."""
    tree = ast.parse((ROOT / "lam_slide_tpu" / "train" / "cli.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) and key.value == "launch":
                    return {k.value for k in value.keys}
    raise AssertionError("no launch block in the JAX CLI")


@pytest.fixture
def test_passes(monkeypatch):
    """The CLI's test passes (k_chunk=1; the val hook passes none)."""
    captured = []
    real = ttesting.evaluate_min_k

    def spy(ss, loaders, **kw):
        out = real(ss, loaders, **kw)
        if kw.get("k_chunk") == 1:
            captured.append((ss, loaders, kw, out))
        return out

    monkeypatch.setattr(ttesting, "evaluate_min_k", spy)
    return captured


def _run(ws, workload, *extra):
    common = ["--smoke", "--workspace", ws, "--device", "cpu", "--epochs", "1", *extra]
    assert main(["--experiment", f"{workload}_first_stage", "--run-id", "s1", *common]) == 0
    assert main(["--experiment", f"{workload}_second_stage", "--run-id", "s2",
                 "--first-stage-run", "s1", "--test", *common]) == 0


@pytest.mark.parametrize("workload", ["pedestrian", "nba"])
def test_cli_smoke_stages_and_min_k_test_pass(tmp_path, test_passes, workload):
    ws = str(tmp_path / "ws")
    _run(ws, workload)
    (ss, loaders, kw, metrics), = test_passes
    jrun = getattr(jreg, f"{workload}_second_stage")(smoke=True)
    cfg = jrun.meta["config"]
    # the fp32 rebuild, not the training DiT, over the test split
    assert ss.backbone.backbone.dtype == torch.float32
    for module in (ss.backbone, ss.first_stage):
        for name, t in module.state_dict().items():
            assert not t.is_floating_point() or t.dtype == torch.float32, name
    assert [l.dataset.__dict__.get("phase", l.dataset.__dict__.get("split"))
            for l in loaders.values()] == ["test"] * len(jrun.test_loaders)
    assert set(loaders) == set(jrun.test_loaders)
    k = min(cfg["K"], 2)  # a smoke run's K
    assert kw == dict(k=k, num_runs=min(cfg["num_runs"], k), k_chunk=1,
                      post_process=cfg["post_process"], mesh=None)  # mesh: --test-mesh
    suffixes = ("ade", "fde") + (("ade_post", "fde_post") if cfg["post_process"] else ())
    stored = json.load(open(tmp_path / "ws" / "s2" / "test_metrics.json"))
    assert stored == metrics
    assert set(stored) == {f"test/{s}/{m}" for s in jrun.test_loaders for m in suffixes}
    assert all(np.isfinite(v) and v > 0 for v in stored.values())

    registry = json.load(open(tmp_path / "ws" / "runs.json"))
    launch = registry["s2"]["config"]["launch"]
    assert set(launch) == _jax_launch_keys()
    assert launch["scene"] == "score" and launch["first_stage_run"] == "s1"
    assert registry["s2"]["config"]["first_stage_run"] == "s1"
    assert [registry[r]["config"]["domain"] for r in ("s1", "s2")] == [workload] * 2
    for run_id, splits in (("s1", ["train", *(f"val/{s}" for s in jrun.val_loaders)]),
                           ("s2", ["train", *(f"val/{s}" for s in jrun.val_loaders),
                                   "hook/val_sample"])):
        records = [json.loads(line) for line in open(tmp_path / "ws" / run_id / "metrics.jsonl")]
        assert [r["split"] for r in records] == splits
        assert all(np.isfinite(v) for r in records for v in r.values() if isinstance(v, float))


def test_test_only_recovers_the_scene(tmp_path, test_passes):
    """NBA on the rebound scene: the runs record it, the test pass reports
    it, and --test-only without --scene reads it back from the run
    registry (a --scene that disagrees is used, with a warning)."""
    ws = str(tmp_path / "ws")
    _run(ws, "nba", "--scene", "rebound")
    registry = json.load(open(tmp_path / "ws" / "runs.json"))
    assert registry["s1"]["config"]["scene"] == registry["s2"]["config"]["scene"] == "rebound"
    assert registry["s2"]["config"]["launch"]["scene"] == "rebound"
    trained = json.load(open(tmp_path / "ws" / "s2" / "test_metrics.json"))
    assert {key.split("/")[1] for key in trained} == {"rebound"}

    (tmp_path / "ws" / "s2" / "test_metrics.json").unlink()
    assert main(["--workspace", ws, "--run-id", "s2", "--test-only", "--device", "cpu"]) == 0
    retest = json.load(open(tmp_path / "ws" / "s2" / "test_metrics.json"))
    assert set(retest) == set(trained)
    assert all(np.isfinite(v) for v in retest.values())
    ss, loaders, kw, _ = test_passes[-1]
    assert list(loaders) == ["rebound"] and kw["post_process"] and kw["k_chunk"] == 1
    assert ss.backbone.backbone.dtype == torch.float32
