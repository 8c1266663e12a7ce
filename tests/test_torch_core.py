"""The port's copies of the framework-free modules (planner, mapping,
benchmarks, dataset, batcher) against the reference's: equal results."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import nn_benchmarks as j_nn
from repro.core import planner as j_planner
from repro.core.onoc_model import FCNNWorkload as JWorkload
from repro.core.onoc_model import ONoCConfig as JONoC
from repro.data import Batcher as JBatcher
from repro.data import fcnn_classification_dataset as j_dataset
from repro_torch.configs import nn_benchmarks
from repro_torch.core import planner
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.data import Batcher, fcnn_classification_dataset


def test_benchmark_tables_are_copies():
    assert nn_benchmarks.NN_BENCHMARKS == j_nn.NN_BENCHMARKS
    assert nn_benchmarks.BATCH_SIZES == j_nn.BATCH_SIZES


@pytest.mark.parametrize("arch", sorted(j_nn.NN_BENCHMARKS))
@pytest.mark.parametrize("strategy", ["fm", "rrm", "orrm"])
def test_plan_fcnn_matches_reference(arch, strategy):
    sizes = j_nn.NN_BENCHMARKS[arch]
    for batch in (1, 64):
        for ring in (1, 8, 12):
            ours = planner.plan_fcnn(
                FCNNWorkload(sizes, batch_size=batch), ONoCConfig(),
                planner.ring_mesh_axes(ring), strategy=strategy)
            ref = j_planner.plan_fcnn(
                JWorkload(sizes, batch_size=batch), JONoC(),
                j_planner.ring_mesh_axes(ring), strategy=strategy)
            assert ours.degrees == ref.degrees
            assert ours.strategy == ref.strategy
            for p, q in zip(ours.periods, ref.periods):
                assert dataclasses.astuple(p) == dataclasses.astuple(q)
            assert ours.mapping.windows == ref.mapping.windows
            assert ours.mapping.reuse == ref.mapping.reuse
            assert (ours.mapping.cores_per_period
                    == ref.mapping.cores_per_period)


@pytest.mark.parametrize("mesh", [{"data": 1}, {"data": 4, "model": 2},
                                  {"model": 2, "data": 3, "pod": 2}])
def test_feasible_degrees_match_reference(mesh):
    assert planner.feasible_degrees(mesh) == j_planner.feasible_degrees(mesh)


@pytest.mark.parametrize("n,dim,seed", [(64, 784, 0), (33, 1024, 7)])
def test_dataset_is_bit_identical(n, dim, seed):
    x, y = fcnn_classification_dataset(n, input_dim=dim, seed=seed)
    jx, jy = j_dataset(n, input_dim=dim, seed=seed)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype == np.int32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_batcher_yields_reference_batches_and_resumes():
    x, y = fcnn_classification_dataset(10, input_dim=6, seed=1)
    ours = Batcher({"x": x, "y": y}, batch_size=4, device="cpu")
    ref = JBatcher({"x": x, "y": y}, batch_size=4)
    for _ in range(6):      # wraps around the 10 samples several times
        b, jb = next(ours), next(ref)
        assert b["y"].dtype == torch.int32
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(jb["x"]))
        np.testing.assert_array_equal(b["y"].numpy(), np.asarray(jb["y"]))
    state = ours.state()
    after = next(ours)
    resumed = Batcher({"x": x, "y": y}, batch_size=4, device="cpu")
    resumed.restore(state)
    assert torch.equal(next(resumed)["x"], after["x"])
