"""The paper's own analyses in the port's ``core/`` (copies of the
reference's ``onoc_model``, ``allocation``, ``analyses``, ``wavelength``,
``energy`` and ``baselines``) against the reference's modules over the
paper's grid: NN1-NN6 x {FM, RRM, ORRM} x the wavelength budgets x the
batch sizes.  Integer results (core counts, hotspot periods, state
transitions, path lengths, wavelength assignments, FGP/FNP cores) must
be equal; floats (epoch times, prediction error, insertion loss, memory
bytes, energies) within rtol 1e-12.  The cases of the reference's own
tests of these modules (``test_onoc_model.py``, ``test_wavelength.py``,
``test_simulator_energy.py``, ``test_allocation.py``) run on both.  The
analyses that walk every sender and receiver of every transition are in
``test_torch_core_rwa.py``."""

import dataclasses
import enum
import math

import numpy as np
import pytest

from repro.configs import nn_benchmarks as j_nn
from repro.core import allocation as j_alloc
from repro.core import analyses as j_an
from repro.core import baselines as j_base
from repro.core import energy as j_energy
from repro.core import onoc_model as j_model
from repro.core import simulator as j_sim
from repro.core import wavelength as j_wl
from repro_torch.configs import nn_benchmarks as nn
from repro_torch.core import allocation, analyses, baselines, energy
from repro_torch.core import onoc_model as model
from repro_torch.core import simulator as sim
from repro_torch.core import wavelength as wl

RTOL = 1e-12
STRATEGIES = ("fm", "rrm", "orrm")


def _same(a, b, path="") -> None:
    """Integers, strings and booleans equal; floats within RTOL; numpy
    arrays by dtype kind; containers and dataclasses field by field."""
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        assert getattr(a, "value", a) == getattr(b, "value", b), path
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _pair(name, batch, lam):
    return (nn.workload(name, batch), nn.onoc_config(lam),
            j_nn.workload(name, batch), j_nn.onoc_config(lam))


def test_benchmark_grid_is_a_copy():
    assert nn.WAVELENGTHS == j_nn.WAVELENGTHS
    assert nn.FNP_FIXED_CORES == j_nn.FNP_FIXED_CORES
    assert nn.ENOC_CORE_SWEEP == j_nn.ENOC_CORE_SWEEP
    _same(nn.onoc_config(), j_nn.onoc_config())
    _same(nn.onoc_config(8, 250), j_nn.onoc_config(8, 250))
    _same(nn.workload("NN3", 32), j_nn.workload("NN3", 32))


@pytest.mark.parametrize("batch", j_nn.BATCH_SIZES)
@pytest.mark.parametrize("lam", j_nn.WAVELENGTHS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", sorted(j_nn.NN_BENCHMARKS))
def test_mapping_and_epoch_match_reference(name, strategy, lam, batch):
    """Over the whole grid: the Lemma-1 mapping, the mapping matrix, Table
    1's state transitions in closed form, Eq. (20)'s memory per core, and
    the ONoC and ENoC epochs."""
    w, cfg, jw, jcfg = _pair(name, batch, lam)
    mp = allocation.map_cores(w, cfg, strategy)
    jmp = j_alloc.map_cores(jw, jcfg, strategy)
    _same(mp, jmp)
    _same(allocation.neuron_assignment(w, mp),
          j_alloc.neuron_assignment(jw, jmp))
    assert (analyses.state_transitions_closed_form(mp)
            == j_an.state_transitions_closed_form(jmp))
    for psi in (2, 4):
        _same(analyses.memory_per_core_bytes(w, mp, psi_bytes=psi),
              j_an.memory_per_core_bytes(jw, jmp, psi_bytes=psi))
    _same(analyses.max_memory_requirement_bytes(w, mp),
          j_an.max_memory_requirement_bytes(jw, jmp))
    for backend, j_backend in ((None, None),
                               (sim.ENoCBackend(), j_sim.ENoCBackend())):
        _same(sim.simulate_epoch(w, cfg, mapping=mp, backend=backend),
              j_sim.simulate_epoch(jw, jcfg, mapping=jmp, backend=j_backend))


@pytest.mark.parametrize("batch", j_nn.BATCH_SIZES)
@pytest.mark.parametrize("lam", j_nn.WAVELENGTHS)
@pytest.mark.parametrize("name", sorted(j_nn.NN_BENCHMARKS))
def test_epoch_model_and_baselines_match_reference(name, lam, batch):
    """Eq. (7)'s epoch time and its periods, Theorem 1 with and without
    the plateau refinement, theta, and the FGP/FNP baselines (Table 8's
    fixed 200 cores and Fig. 10's ENoC sweep) timed on both."""
    w, cfg, jw, jcfg = _pair(name, batch, lam)
    for refine in (False, True):
        _same(model.optimal_epoch_time(w, cfg, refine_plateau=refine),
              j_model.optimal_epoch_time(jw, jcfg, refine_plateau=refine))
    for i in range(1, w.l + 1):
        _same(model.theta(w, cfg, i), j_model.theta(jw, jcfg, i))
    plans = [baselines.fgp_cores(w, cfg), baselines.fnp_cores(w, cfg)]
    _same(plans, [j_base.fgp_cores(jw, jcfg), j_base.fnp_cores(jw, jcfg)])
    assert plans[1] == baselines.fnp_cores(w, cfg, nn.FNP_FIXED_CORES)
    for fixed in nn.ENOC_CORE_SWEEP:
        plans.append(baselines.fnp_cores(w, cfg, fixed))
        _same(plans[-1], j_base.fnp_cores(jw, jcfg, fixed))
    for cores in plans:
        _same(model.epoch_time(w, cfg, cores),
              j_model.epoch_time(jw, jcfg, cores))


@pytest.mark.parametrize("batch", (1, 32))
@pytest.mark.parametrize("lam", j_nn.WAVELENGTHS)
@pytest.mark.parametrize("name", sorted(j_nn.NN_BENCHMARKS))
def test_prediction_error_and_brute_force_match_reference(name, lam, batch):
    """Table 7's (APE_raw, APE_plateau, APD) and the per-period argmin it
    is measured against (the batch sizes of the reference's test)."""
    w, cfg, jw, jcfg = _pair(name, batch, lam)
    _same(model.brute_force_optimal_cores(w, cfg),
          j_model.brute_force_optimal_cores(jw, jcfg))
    got = model.prediction_error(w, cfg, refine_plateau=True)
    _same(got, j_model.prediction_error(jw, jcfg, refine_plateau=True))
    assert got[1] <= 0.05 and got[2] <= 0.1


@pytest.mark.parametrize("sizes,cores,m", [
    ([784, 100, 10], [32, 10], 64),        # the reference's valid case
    ([784, 100, 10], [100, 10], 64),       # exceeds phi*m (Eq. 9)
    ([784, 100, 10], [0, 10], 64),         # fewer than one core
    ([784, 100, 10], [32, 11], 64),        # more cores than neurons (Eq. 10)
    ([784, 100, 10], [32], 64),            # one count short
])
def test_epoch_time_constraints_match_reference(sizes, cores, m):
    """``epoch_time``'s periods (Eq. 11) and ``_check_constraints``'s
    refusals, message for message."""
    w, jw = model.FCNNWorkload(sizes, 4), j_model.FCNNWorkload(sizes, 4)
    cfg, jcfg = model.ONoCConfig(m=m, lambda_max=8), j_model.ONoCConfig(
        m=m, lambda_max=8)
    try:
        want = j_model.epoch_time(jw, jcfg, cores)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("*", r"\*")):
            model.epoch_time(w, cfg, cores)
        return
    got = model.epoch_time(w, cfg, cores)
    _same(got, want)
    t, periods = got
    for i in range(1, w.l + 1):
        assert periods[i - 1].m == periods[2 * w.l - i].m
    assert t == pytest.approx(sum(p.total_s for p in periods))


@pytest.mark.parametrize("sizes", [[97, 4, 600, 10], [97, 313, 12, 77, 10],
                                   [80, 16, 500, 10], [97, 600, 10]])
@pytest.mark.parametrize("m,lam", [(64, 4), (250, 8), (1000, 64)])
def test_property_cases_match_reference(sizes, m, lam):
    """The reference's property tests' quantities at fixed draws: Lemma 1
    and the brute-force optimum, compute and comm times per period
    (Eq. 5/6), ``_neurons_in_period`` and the constraints they obey."""
    for bs in (1, 8, 32):
        w, jw = model.FCNNWorkload(sizes, bs), j_model.FCNNWorkload(sizes, bs)
        cfg = model.ONoCConfig(m=m, lambda_max=lam)
        jcfg = j_model.ONoCConfig(m=m, lambda_max=lam)
        stars = model.optimal_cores(w, cfg)
        _same(stars, j_model.optimal_cores(jw, jcfg))
        _same(model.brute_force_optimal_cores(w, cfg),
              j_model.brute_force_optimal_cores(jw, jcfg))
        for i in range(1, 2 * w.l + 1):
            assert (model._neurons_in_period(w, i)
                    == j_model._neurons_in_period(jw, i))
            for mi in (1, 2, 4, 8):
                _same(model.compute_time(w, cfg, i, mi),
                      j_model.compute_time(jw, jcfg, i, mi))
                _same(model.comm_time(w, cfg, i, mi),
                      j_model.comm_time(jw, jcfg, i, mi))
        for i, mi in enumerate(stars, start=1):
            model._check_constraints(w, cfg, i, mi)
        for s in STRATEGIES:
            _same(sim.simulate_epoch(w, cfg, strategy=s,
                                     cores_per_period=stars),
                  j_sim.simulate_epoch(jw, jcfg, strategy=s,
                                       cores_per_period=stars))


@pytest.mark.parametrize("n_send,n_recv,lam,m", [
    (1, 1, 2, 45), (7, 40, 2, 100), (40, 3, 8, 60), (33, 33, 64, 80),
    (40, 40, 8, 100), (13, 29, 64, 45)])
def test_wavelength_assignments_match_reference(n_send, n_recv, lam, m):
    """``assign_wavelengths`` (the WM matrix and the TDM slots, Fig. 6) on
    the reference test's sender/receiver layout, with overlapping sets."""
    for senders, receivers in (
            (list(range(n_send)), list(range(40, 40 + n_recv))),
            (list(range(n_send))[::-1] * 2, list(range(n_recv)))):
        got = wl.assign_wavelengths(senders, receivers, lam, m + 60, 3, "ccw")
        want = j_wl.assign_wavelengths(senders, receivers, lam, m + 60, 3,
                                       "ccw")
        _same(got, want)
        assert got.n_slots == -(-len(set(senders)) // lam)
    with pytest.raises(ValueError):
        wl.assign_wavelengths([0], [1], 0, 4)


@pytest.mark.parametrize("n_routers", [0, 1, 2, 17, 1000])
def test_insertion_loss_matches_reference(n_routers):
    loss = analyses.OpticalLossParams(il_link_db=0.1, il_router_db=0.02)
    jloss = j_an.OpticalLossParams(il_link_db=0.1, il_router_db=0.02)
    _same(analyses.insertion_loss_db(n_routers),
          j_an.insertion_loss_db(n_routers))
    _same(analyses.insertion_loss_db(n_routers, loss),
          j_an.insertion_loss_db(n_routers, jloss))


def test_energy_with_custom_constants_matches_reference():
    """``onoc_energy``/``enoc_energy`` with non-default constants and loss
    parameters (the reference's energy tests use the defaults)."""
    w, cfg, jw, jcfg = _pair("NN2", 64, 64)
    params = dict(core_active_w=0.3, eo_oe_pj_per_bit=2.0, mrs_per_router=8,
                  laser_efficiency=0.2, router_pj_per_bit=1.0)
    loss = dict(il_link_db=0.05, il_oe_db=1.5)
    for fixed in nn.ENOC_CORE_SWEEP:
        cores = baselines.fnp_cores(w, cfg, fixed)
        mp = allocation.map_cores(w, cfg, "fm", cores)
        jmp = j_alloc.map_cores(jw, jcfg, "fm", cores)
        tr = sim.simulate_epoch(w, cfg, mapping=mp)
        jtr = j_sim.simulate_epoch(jw, jcfg, mapping=jmp)
        _same(energy.onoc_energy(tr, mp, 7, energy.EnergyParams(**params),
                                 analyses.OpticalLossParams(**loss)),
              j_energy.onoc_energy(jtr, jmp, 7,
                                   j_energy.EnergyParams(**params),
                                   j_an.OpticalLossParams(**loss)))
        etr = sim.simulate_epoch(w, cfg, mapping=mp, backend=sim.ENoCBackend())
        jetr = j_sim.simulate_epoch(jw, jcfg, mapping=jmp,
                                    backend=j_sim.ENoCBackend())
        _same(energy.enoc_energy(etr, mp, 7, energy.EnergyParams(**params)),
              j_energy.enoc_energy(jetr, jmp, 7,
                                   j_energy.EnergyParams(**params)))


def test_core_exports_match_reference():
    """Every name the reference's ``repro.core`` exports (its modules
    aside) is exported by the port's."""
    import types

    import repro.core as jc
    import repro_torch.core as tc

    names = {n for n in dir(jc) if not n.startswith("_")
             and not isinstance(getattr(jc, n), types.ModuleType)}
    assert names <= set(dir(tc)), sorted(names - set(dir(tc)))
