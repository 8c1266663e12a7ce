"""The degraded-mode runner on the card: NN1 at full width through its
ORRM program on an 8-device ring of logical devices, 20 steps, two
devices lost at step 10, a checkpoint every 5 steps.  Every case is
marked ``gpu`` and skips where there is no CUDA device; the file imports
no jax:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_runtime_gpu.py
"""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import elastic_restart as er
from repro_torch.models import fcnn
from repro_torch.runtime import FaultEvent, FaultKind, FaultSchedule

SCENARIO = er.Scenario(n_steps=20, checkpoint_every=5)
LOSS = FaultSchedule(events=tuple(
    FaultEvent(kind=FaultKind.DEVICE_LOSS, step=10, period=2, device=d)
    for d in (6, 7)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(cuda, schedule, n_devices, residency="sharded"):
    ops.reset_launches()
    return er.recovery_run(SCENARIO, schedule, n_devices, residency, cuda)


@pytest.mark.gpu
def test_device_loss_recovers_through_the_kernels_on_card(cuda):
    out = _run(cuda, LOSS, 8)
    report = out["report"]
    assert report.kernel_fallbacks == 0
    assert report.resumed_from == [9]
    assert report.replans[0]["to_devices"] == 6
    assert out["runner"].program.degrees == (2, 2, 2)
    before, after = out["clock"].segments()
    for seg in (before, after):
        _, launches = er.per_step(seg)
        assert all(launches[k] > 0 for k in er.FCNN_KERNELS), launches
    assert int(out["state"]["step"]) == 20

    scratch = _run(cuda, FaultSchedule(), 6)
    got, want = out["runner"].losses, scratch["runner"].losses
    assert sorted(got) == list(range(20))
    for s in range(20):
        assert got[s] == pytest.approx(want[s], rel=er.LOSS_RTOL,
                                       abs=er.LOSS_ATOL)
    for a, b in zip(fcnn.parameters(out["state"]["params"]),
                    fcnn.parameters(scratch["state"]["params"])):
        torch.testing.assert_close(a, b, rtol=er.PARAM_RTOL,
                                   atol=er.PARAM_ATOL)


@pytest.mark.gpu
def test_sharded_recovery_equals_replicated_on_card(cuda):
    sharded = _run(cuda, LOSS, 8, "sharded")
    repl = _run(cuda, LOSS, 8, "replicated")
    assert sharded["runner"].losses == repl["runner"].losses
    assert all(torch.equal(a, b) for a, b in zip(
        fcnn.parameters(sharded["state"]["params"]),
        fcnn.parameters(repl["state"]["params"])))
