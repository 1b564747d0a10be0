"""The port's checkpoints (checkpoint/checkpointing.py), training runtime
(runtime/fault_tolerance.py) and train CLI (launch/train.py) on the CPU,
mirroring tests/test_checkpoint_runtime.py: a save/restore round trip
(bf16 leaves bit for bit, as uint16 bits), a checkpoint of f32 leaves
written by JAX's ``save`` restored by the port's ``restore`` and the other
way round (one layout), ``latest_step``, the async checkpointer, recovery
from an injected failure, NaN detection, stragglers; then
``python -m repro_torch.launch.train --device cpu`` (6 steps; 10 with a
failure injected at step 5: restarts=1), its refusal to run without a
card unless asked, and a resumed run replaying its steps' losses bit for
bit."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jckpt
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpointing
from repro_torch.runtime.fault_tolerance import (FaultInjector, RuntimeConfig,
                                                 TrainRuntime)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=g),
                       "b": torch.zeros(8),
                       "layers": [{"wq": torch.randn(3, 2, generator=g)
                                   .to(torch.bfloat16)},
                                  {"wq": torch.randn(3, 2, generator=g)
                                   .to(torch.bfloat16)}]},
            "opt": {"m": torch.ones(3), "step": 7}}


def _assert_trees_equal(a, b):
    la, lb = tree_lib.flatten_with_paths(a), tree_lib.flatten_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), key
        else:
            assert type(x) is type(y) and x == y, key


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    checkpointing.save(tmp_path, 3, t, extra={"step": 3})
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    dtypes = {m["key"]: m["dtype"] for m in manifest["leaves"]}
    assert dtypes["params/layers/0/wq"] == "bfloat16"
    assert np.load(tmp_path / "step_00000003" /
                   "params__layers__0__wq.npy").dtype == np.uint16
    like = _tree(seed=1)          # other values, the same structure
    restored, extra = checkpointing.restore(tmp_path, 3, like)
    assert extra["step"] == 3
    _assert_trees_equal(restored, t)


def test_latest_step(tmp_path):
    assert checkpointing.latest_step(tmp_path) is None
    t = _tree()
    checkpointing.save(tmp_path, 1, t)
    checkpointing.save(tmp_path, 9, t)
    (tmp_path / "step_00000012.tmp").mkdir()    # an unpublished save
    assert checkpointing.latest_step(tmp_path) == 9


def test_async_checkpointer(tmp_path):
    ck = checkpointing.AsyncCheckpointer()
    t = _tree()
    ck.save(tmp_path, 5, t)
    t["params"]["w"].add_(1.0)       # after save(): not in the snapshot
    ck.wait()
    assert checkpointing.latest_step(tmp_path) == 5
    restored, _ = checkpointing.restore(tmp_path, 5, t)
    assert torch.equal(restored["params"]["w"], _tree()["params"]["w"])


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """One layout: JAX's save of f32 (and int32) leaves restores through
    the port's restore, and the port's save through JAX's."""
    rng = np.random.RandomState(0)
    jt = {"params": {"w": jnp.asarray(rng.randn(4, 8).astype(np.float32)),
                     "layers": [{"wq": jnp.asarray(rng.randn(3, 2).astype(
                         np.float32))}]},
          "opt": {"m": jnp.ones((3,)), "step": jnp.int32(7)}}
    jckpt.save(tmp_path / "j", 4, jt, extra={"step": 4})
    like = {"params": {"w": torch.zeros(4, 8),
                       "layers": [{"wq": torch.zeros(3, 2)}]},
            "opt": {"m": torch.zeros(3), "step": 0}}
    got, extra = checkpointing.restore(tmp_path / "j", 4, like)
    assert extra == {"step": 4} and got["opt"]["step"] == 7
    for (key, a), b in zip(tree_lib.flatten_with_paths(got),
                           jax.tree.leaves(jt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), key)
    checkpointing.save(tmp_path / "t", 6, got)
    back, _ = jckpt.restore(tmp_path / "t", 6, jt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _quadratic_runtime(tmp_path, injector=None, ckpt_every=2):
    state = {"params": {"w": torch.tensor([4.0])}}

    def step_fn(state, batch, step):
        w = state["params"]["w"]
        w = w - 0.1 * (2 * w)
        return {"state": {"params": {"w": w}},
                "metrics": {"loss": torch.sum(w * w)}}

    cfg = RuntimeConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                        max_restarts=3)
    return TrainRuntime(cfg, state, step_fn, injector)


def test_runtime_runs_to_completion(tmp_path):
    rt = _quadratic_runtime(tmp_path)
    state = rt.run(iter(lambda: 0, 1), num_steps=10)
    assert rt.step == 10
    assert float(state["params"]["w"][0]) < 1.0
    assert checkpointing.latest_step(tmp_path) == 10


def test_runtime_recovers_from_injected_failure(tmp_path):
    inj = FaultInjector(fail_at_steps=[5])
    rt = _quadratic_runtime(tmp_path, inj)
    state = rt.run(iter(lambda: 0, 1), num_steps=10)
    assert rt.restarts == 1
    assert rt.step == 10
    # the restart replayed from step 4's checkpoint: the same final value
    # as a run without the failure
    clean = _quadratic_runtime(tmp_path / "clean").run(iter(lambda: 0, 1),
                                                       num_steps=10)
    assert torch.equal(state["params"]["w"], clean["params"]["w"])


def test_runtime_batches_by_step(tmp_path):
    """``batches`` as a function of the first step: a restart reads the
    batches of the steps it replays."""
    seen = []

    def step_fn(state, batch, step):
        seen.append((step, batch))
        return {"state": state, "metrics": {"loss": torch.tensor(1.0)}}

    cfg = RuntimeConfig(ckpt_dir=str(tmp_path), ckpt_every=3)
    rt = TrainRuntime(cfg, {"w": torch.zeros(1)}, step_fn,
                      FaultInjector([4]))
    rt.run(lambda s: iter(range(s, 100)), num_steps=6)
    assert rt.restarts == 1
    assert all(step == batch for step, batch in seen)
    assert [s for s, _ in seen] == [0, 1, 2, 3, 3, 4, 5]


def test_runtime_detects_nan(tmp_path):
    state = {"params": {"w": torch.tensor([1.0])}}
    calls = {"n": 0}

    def step_fn(state, batch, step):
        calls["n"] += 1
        # NaN once at step 4 (before any restart)
        w = state["params"]["w"]
        loss = torch.sum(w * w)
        if step == 4 and calls["n"] <= 5:
            loss = torch.tensor(float("nan"))
        return {"state": state, "metrics": {"loss": loss}}

    cfg = RuntimeConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                        max_restarts=3)
    rt = TrainRuntime(cfg, state, step_fn)
    rt.run(iter(lambda: 0, 1), num_steps=8)
    assert rt.restarts >= 1
    assert rt.step == 8


def test_runtime_gives_up_after_max_restarts(tmp_path):
    def step_fn(state, batch, step):
        return {"state": state, "metrics": {"loss": torch.tensor(
            float("inf"))}}

    cfg = RuntimeConfig(ckpt_dir=str(tmp_path), max_restarts=2)
    rt = TrainRuntime(cfg, {"w": torch.zeros(1)}, step_fn)
    with pytest.raises(FloatingPointError, match="non-finite"):
        rt.run(iter(lambda: 0, 1), num_steps=3)
    assert rt.restarts == 3


def test_straggler_detection(tmp_path):
    state = {"params": {"w": torch.tensor([1.0])}}

    def step_fn(state, batch, step):
        if step == 7:
            time.sleep(0.25)
        return {"state": state, "metrics": {"loss": torch.tensor(1.0)}}

    cfg = RuntimeConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                        straggler_factor=3.0)
    rt = TrainRuntime(cfg, state, step_fn)
    rt.run(iter(lambda: 0, 1), num_steps=10)
    assert any(s == 7 for s, _, _ in rt.straggler_events)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _train_cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--batch", "2", "--seq", "32", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def test_train_cli_runs_and_recovers(tmp_path):
    out = _train_cli("--steps", "6", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "a"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "arch=qwen2-0.5b" in out.stdout and "done:" in out.stdout
    out = _train_cli("--steps", "10", "--ckpt-every", "3",
                     "--inject-failure-at", "5", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "b"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restarts=1" in out.stdout


def test_train_cli_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = _train_cli("--steps", "2", "--ckpt-dir", str(tmp_path))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "done:" not in out.stdout


def test_train_resume_replays_bit_for_bit(tmp_path):
    """A run with a failure at step 7 (restart from the step-5
    checkpoint), then a run resumed from its step-10 checkpoint: the
    replayed steps' losses equal the first run's bit for bit."""
    from repro_torch.launch import train
    common = ["--arch", "qwen2-0.5b", "--device", "cpu", "--batch", "2",
              "--seq", "32", "--steps", "14", "--ckpt-every", "5"]
    first = train.main(common + ["--ckpt-dir", str(tmp_path / "a"),
                                 "--inject-failure-at", "7"])
    assert first["restarts"] == 1 and len(first["losses"]) == 14 + 2
    src = tmp_path / "a" / "step_00000010"
    dst = tmp_path / "b" / "step_00000010"
    dst.parent.mkdir()
    os.replace(src, dst)
    again = train.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    assert again["losses"] == first["losses"][-4:]
