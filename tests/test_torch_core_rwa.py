"""The paper's per-transition analyses in the port's ``core/`` against
the reference's: Theorem 2's hotspot, Table 1's state transitions, Table
2's path length, Eq. (19)'s insertion loss, the RWA schedules (Fig. 6)
and the energies, over NN1-NN6 x {FM, RRM, ORRM} x the wavelength
budgets.  Each walks every sender and receiver of every transition in
Python (5-14 s an NN3/NN4/NN6 case at lambda = 8 for the two packages),
so the grid runs at batch 64, at lambda = 64 for every network and at
lambda = 8 for NN1 and NN5, in a file of its own so that a test worker
runs it beside ``test_torch_core_analyses.py``, which holds the rest of
the grid."""

import pytest

from repro.configs import nn_benchmarks as j_nn
from repro.core import allocation as j_alloc
from repro.core import analyses as j_an
from repro.core import energy as j_energy
from repro.core import simulator as j_sim
from repro.core import wavelength as j_wl
from repro_torch.core import allocation, analyses, energy
from repro_torch.core import simulator as sim
from repro_torch.core import wavelength as wl
from test_torch_core_analyses import STRATEGIES, _pair, _same


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name,lam", [
    *((n, 64) for n in sorted(j_nn.NN_BENCHMARKS)), ("NN1", 8), ("NN5", 8)])
def test_mapping_analyses_match_reference(name, lam, strategy, batch=64):
    """Theorem 2's hotspot, Table 1's state transitions, Table 2's path
    length, Eq. (19)'s insertion loss, Eq. (20)'s memory (the strategy
    report), the RWA schedule of every transition, and the ONoC and ENoC
    energies."""
    w, cfg, jw, jcfg = _pair(name, batch, lam)
    mp = allocation.map_cores(w, cfg, strategy)
    jmp = j_alloc.map_cores(jw, jcfg, strategy)
    report = analyses.analyze_mapping(w, mp)
    _same(report, j_an.analyze_mapping(jw, jmp))
    _same(wl.schedule_epoch(mp, lam), j_wl.schedule_epoch(jmp, lam))
    for backend, j_backend in ((None, None),
                               (sim.ENoCBackend(), j_sim.ENoCBackend())):
        tr = sim.simulate_epoch(w, cfg, mapping=mp, backend=backend)
        jtr = j_sim.simulate_epoch(jw, jcfg, mapping=jmp, backend=j_backend)
        if backend is None:
            got = energy.onoc_energy(tr, mp, report.state_transitions)
            want = j_energy.onoc_energy(jtr, jmp, report.state_transitions)
        else:
            got = energy.enoc_energy(tr, mp, report.state_transitions)
            want = j_energy.enoc_energy(jtr, jmp, report.state_transitions)
        _same(got, want)
        _same(got.total_j, want.total_j)
