"""The period-program executor on the card: NN1's ORRM program on an
8-device ring of logical devices, sharded residency against replicated
bit for bit over 5 Adam steps, off-window slots exactly zero, and the
kernel launches of one step.  Every case is marked ``gpu`` and skips
where there is no CUDA device; the file imports no jax:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_exec_gpu.py
"""

import pytest
import torch

from repro_torch import exec as pexec
from repro_torch.configs.nn_benchmarks import NN_BENCHMARKS
from repro_torch.core.onoc_model import FCNNWorkload, ONoCConfig
from repro_torch.data import fcnn_classification_dataset
from repro_torch.kernels import ops
from repro_torch.models import fcnn
from repro_torch.optim import adam

CFG = ONoCConfig(m=1000, lambda_max=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(dev, seed):
    x, y = fcnn_classification_dataset(64, input_dim=784, seed=seed)
    return {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}


@pytest.mark.gpu
def test_sharded_equals_replicated_on_card(cuda):
    w = FCNNWorkload(NN_BENCHMARKS["NN1"], batch_size=64)
    opt = adam(1e-3)
    exes = {r: pexec.compile(w, CFG, 8, strategy="orrm", residency=r,
                             device=cuda)
            for r in ("sharded", "replicated")}
    states = {r: e.init_state(torch.Generator().manual_seed(0), opt)
              for r, e in exes.items()}
    steps = {r: e.train_step(opt) for r, e in exes.items()}
    ops.reset_launches()
    for i in range(5):
        batch = _batch(cuda, i)
        losses = {r: steps[r](states[r], batch)[1]["loss"] for r in exes}
        assert torch.equal(losses["sharded"], losses["replicated"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # per step and residency: K1 = K3 = 8 + 4 + 2, K2 = 4 + 2, K4 = K5 = 1
    assert [counts[k] for k in ("fcnn_layer", "fcnn_layer_dgrad",
                                "fcnn_layer_wgrad", "softmax_xent_fwd",
                                "softmax_xent_dlogits")] == [
        2 * 5 * n for n in (14, 6, 14, 1, 1)]
    sh = exes["sharded"]
    gathered = sh.gather_params(states["sharded"]["params"])
    assert all(torch.equal(a, b) for a, b in zip(
        fcnn.parameters(gathered),
        fcnn.parameters(states["replicated"]["params"])))
    for lay, lp in zip(sh.executor._layout,
                       states["sharded"]["params"]["layers"]):
        for s, c in enumerate(lay.owner_chunk):
            if c is None:
                assert not lp["w"][s].any() and not lp["b"][s].any()
