"""The port's checkpointer (``repro_torch.checkpoint``): the reference's
contract and on-disk format, on trees of tensors.

Round trip, async saves and garbage collection, atomicity under a crash
mid-save (the counterparts of the reference's ``tests/test_substrates.py``
and ``tests/test_fault_tolerance.py`` checkpoint tests), an async save
that an in-place update cannot reach, and checkpoints that restore across
the two packages bit for bit: the same keys, file names and values, for
plain trees and for the degraded-mode runners' own state trees.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint import checkpointer as jckpt
from repro.configs.nn_benchmarks import onoc_config
from repro.core.onoc_model import FCNNWorkload as JWorkload
from repro.data import Batcher as JBatcher
from repro.models import fcnn as jfcnn
from repro.optim import adam as j_adam
from repro.runtime.degraded import DegradedModeRunner as JRunner
from repro.runtime.faults import FaultSchedule as JSchedule
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.checkpoint import checkpointer as pckpt
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.data import Batcher, fcnn_classification_dataset
from repro_torch.models import fcnn
from repro_torch.optim import adam
from repro_torch.runtime import DegradedModeRunner, FaultSchedule

SIZES = [32, 16, 8, 10]


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def _flat(state):
    return {k: pckpt._to_host(v) for k, v in pckpt._flatten(state).items()}


# ----------------------------------------------------------- the contract


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    st = _state(3.0)
    ck.save(10, st)
    assert latest_step(str(tmp_path)) == 10
    restored = ck.restore(10, _state(0.0))
    assert torch.equal(restored["params"]["w"], st["params"]["w"])
    assert restored["step"].dtype == torch.int32
    assert int(restored["step"]) == 3
    assert sorted(os.listdir(tmp_path / "step_10")) == [
        "manifest.json", "params__b.npy", "params__w.npy", "step.npy"]


def test_restore_takes_dtype_and_grad_from_like(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                "step": torch.tensor(7, dtype=torch.int32),
                "pair": (torch.ones(2, requires_grad=True), None)})
    like = {"w": torch.zeros(2, 3, dtype=torch.float64, requires_grad=True),
            "step": torch.zeros((), dtype=torch.float32),
            "pair": (torch.zeros(2), None)}
    out = ck.restore(1, like)
    assert out["w"].dtype == torch.float64 and out["w"].requires_grad
    assert out["w"].is_leaf
    assert out["w"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert out["step"].dtype == torch.float32 and float(out["step"]) == 7.0
    assert isinstance(out["pair"], tuple) and out["pair"][1] is None
    assert not out["pair"][0].requires_grad
    assert out["pair"][0].tolist() == [1.0, 1.0]


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(float(s)), blocking=(s % 2 == 0))
    ck.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]
    assert float(ck.restore(3, _state())["params"]["w"][0, 0]) == 3.0


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _state(1.0), extra_meta={"data_state": {"step": 6}})
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    meta = ck.meta(5)
    assert meta["step"] == 5 and meta["data_state"] == {"step": 6}
    assert meta["keys"] == ["params::b", "params::w", "step"]


def test_checkpoint_crash_atomicity(tmp_path, monkeypatch):
    """A crash mid-write leaves a partial tmp dir and the previous
    checkpoint as the latest; the next save at that step works."""
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, _state(1.0), blocking=True)
    real_save = np.save
    calls = {"n": 0}

    def dying_save(path, arr):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("simulated crash mid-write")
        real_save(path, arr)

    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(OSError):
        ck.save(3, _state(3.0), blocking=True)
    monkeypatch.setattr(np, "save", real_save)

    assert os.path.isdir(tmp_path / "tmp.3")
    assert not os.path.isdir(tmp_path / "step_3")
    assert latest_step(str(tmp_path)) == 1
    restored = ck.restore(1, _state(0.0))
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 1.0))
    Checkpointer(str(tmp_path), keep=3).save(3, _state(3.0), blocking=True)
    assert latest_step(str(tmp_path)) == 3


def test_async_crash_leaves_previous_checkpoint(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(2, _state(2.0), blocking=True)

    def always_die(path, arr):
        raise OSError("simulated crash mid-write")

    monkeypatch.setattr(np, "save", always_die)
    ck.save(4, _state(4.0), blocking=False)
    ck.wait()      # the thread died; its exception stays in the thread
    assert latest_step(str(tmp_path)) == 2


def test_async_save_is_not_reached_by_in_place_updates(tmp_path,
                                                       monkeypatch):
    """The port's optimizer updates tensors in place.  A save in flight
    must hold the values of the step it was taken at: the snapshot is a
    copy, not a view of the CPU tensor's memory."""
    gate = __import__("threading").Event()
    real_save = np.save

    def held_save(path, arr):
        gate.wait(timeout=10)
        real_save(path, arr)

    monkeypatch.setattr(np, "save", held_save)
    ck = Checkpointer(str(tmp_path))
    st = _state(1.0)
    ck.save(1, st, blocking=False)
    with torch.no_grad():           # the next step, in place
        st["params"]["w"].add_(5.0)
        st["params"]["b"].sub_(1.0)
        st["step"] += 1
    gate.set()
    ck.wait()
    restored = ck.restore(1, _state())
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 1.0))
    assert torch.equal(restored["params"]["b"], torch.zeros(4))
    assert int(restored["step"]) == 1


# ------------------------------------------------------ across the packages


def _tree_np():
    rng = np.random.default_rng(0)
    return {"params": {"layers": [
        {"w": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(np.float32)}
        for _ in range(2)]},
        "opt_state": {"m": [rng.normal(size=(2,)).astype(np.float32)],
                      "pair": (np.arange(3, dtype=np.int32),
                               np.float32(2.0)),
                      "none": None},
        "step": np.int32(12)}


def test_keys_and_file_names_equal_the_references():
    tree = _tree_np()
    assert sorted(pckpt._flatten(tree)) == sorted(jckpt._flatten(tree))
    for k in pckpt._flatten(tree):
        assert pckpt._fname(k) == jckpt._fname(k)
    assert "params::layers::[1]::w" in pckpt._flatten(tree)


def test_plain_trees_restore_across_packages(tmp_path):
    tree = _tree_np()
    t_tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)
    t_tree["opt_state"]["none"] = None
    Checkpointer(str(tmp_path / "port")).save(3, t_tree)
    j_tree = jax.tree.map(jnp.asarray, tree)
    JCheckpointer(str(tmp_path / "ref")).save(3, j_tree)

    from_port = JCheckpointer(str(tmp_path / "port")).restore(3, j_tree)
    from_ref = Checkpointer(str(tmp_path / "ref")).restore(3, t_tree)
    want = _flat(t_tree)
    for k, v in jckpt._flatten(from_port).items():
        assert np.asarray(v).dtype == want[k].dtype
        np.testing.assert_array_equal(np.asarray(v), want[k], strict=True)
    for k, v in _flat(from_ref).items():
        np.testing.assert_array_equal(v, want[k], strict=True)
    assert Checkpointer(str(tmp_path / "port")).meta(3)["keys"] == \
        JCheckpointer(str(tmp_path / "ref")).meta(3)["keys"]


W = FCNNWorkload(SIZES, batch_size=8)
CFG = ONoCConfig(m=8, lambda_max=64)
X, Y = fcnn_classification_dataset(64, input_dim=SIZES[0], seed=3)


def _params_np():
    return jax.tree.map(np.asarray,
                        jfcnn.init(jax.random.PRNGKey(0), SIZES))


def test_runner_checkpoints_restore_across_packages(tmp_path):
    """Each package's degraded-mode runner saves its own state tree
    (``params``, ``opt_state`` = {m, v}, ``step``) after 4 steps; the
    other package restores it into its runner's state tree, bit for bit
    (the step counter cast from the port's fp32 to the reference's int32
    and back)."""
    p_np = _params_np()
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")

    params0 = fcnn.params_from_numpy(p_np, "cpu")
    opt = adam(1e-2)
    port = DegradedModeRunner(
        workload=W, base_cfg=CFG, schedule=FaultSchedule(),
        checkpointer=Checkpointer(port_dir), optimizer=opt, n_devices=8,
        kernel_mode="ref", residency="sharded", checkpoint_every=4,
        backoff_s=0.0, device="cpu")
    port_state, _, _ = port.run(params0, opt.init(params0),
                                Batcher({"x": X, "y": Y}, 8, "cpu"), 4)

    jparams = jax.tree.map(jnp.asarray, p_np)
    jopt = j_adam(1e-2)
    ref = JRunner(
        workload=JWorkload(SIZES, batch_size=8),
        base_cfg=dataclasses.replace(onoc_config(64), m=8),
        schedule=JSchedule(), checkpointer=JCheckpointer(ref_dir),
        optimizer=jopt, n_devices=8, kernel_mode="ref",
        residency="sharded", checkpoint_every=4, backoff_s=0.0)
    ref_state, _, _ = ref.run(jparams, jopt.init(jparams),
                              JBatcher({"x": X, "y": Y}, batch_size=8), 4)

    assert Checkpointer(port_dir).meta(3)["keys"] == \
        JCheckpointer(ref_dir).meta(3)["keys"]
    assert Checkpointer(port_dir).meta(3)["data_state"] == {"step": 4}

    # the port's checkpoint in the reference's state tree
    j_like = {"params": jparams, "opt_state": jopt.init(jparams),
              "step": jnp.asarray(0, jnp.int32)}
    got = JCheckpointer(port_dir).restore(3, j_like)
    want = _flat(port_state)
    for k, v in jckpt._flatten(got).items():
        if k == "step":
            assert np.asarray(v).dtype == np.int32 and int(v) == 4
        else:
            np.testing.assert_array_equal(np.asarray(v), want[k],
                                          strict=True)
    # the reference's checkpoint in the port's state tree
    got = Checkpointer(ref_dir).restore(3, port_state)
    want = {k: np.asarray(v) for k, v in jckpt._flatten(ref_state).items()}
    for k, v in _flat(got).items():
        if k == "step":
            assert v.dtype == np.float32 and float(v) == 4.0
        else:
            np.testing.assert_array_equal(v, want[k], strict=True)
    assert all(t.requires_grad for t in fcnn.parameters(got["params"]))
