"""The dry-run (``launch/dryrun.py``, ``dryrun_fcnn.py``) held to the card
at smoke width: for one bf16 smoke config of each LM family, a train
step, a prefill and a decode step, and for NN1's executor step, the
prediction on the meta device (``chip_smoke.predict_cell``) against one
step on the card from ``reset_peak_memory_stats`` with its state
allocated after it (``chip_smoke.card_cell``): the predicted K1-K7
launches equal the card's, kernel by kernel, and the predicted peak is
within 10% of ``max_memory_allocated`` or 64 MiB (these steps allocate a
few MiB, where the caching allocator's blocks of a large tensor, rounded
past its 512 bytes, weigh).  Marked ``gpu``; skips without a card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dryrun_gpu.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.launch.steps import TrainSettings

FAMILY_ARCHS = {"dense": "granite-3-2b", "moe": "qwen2-moe-a2.7b",
                "ssm": "mamba2-2.7b", "hybrid": "zamba2-1.2b",
                "encdec": "seamless-m4t-large-v2", "vlm": "qwen2-vl-72b"}
PEAK_RTOL, PEAK_SLACK = 0.10, 64 * 2**20

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _hold(cell, dev):
    pred = SMOKE.predict_cell(cell)
    got = SMOKE.card_cell(torch, dev, cell)
    assert pred["kernel_launches"] == got["launches"]
    gap = abs(pred["peak_memory_per_device"] - got["peak"])
    assert gap <= PEAK_RTOL * got["peak"] or gap <= PEAK_SLACK, \
        (pred["peak_memory_per_device"], got["peak"])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_dryrun_matches_card_on_smoke_cells(cuda, family, kind):
    arch = FAMILY_ARCHS[family]
    cfg = smoke_config(arch).replace(dtype="bfloat16",
                                     param_dtype="bfloat16", remat=True)
    cell = SMOKE.DryCell(f"{arch} smoke {kind}", "b", arch,
                         ShapeSpec(kind, 128, 2, kind),
                         TrainSettings() if kind == "train" else None,
                         cfg=cfg)
    _hold(cell, cuda)


@pytest.mark.gpu
def test_dryrun_matches_card_on_the_nn1_executor_step(cuda):
    _hold(SMOKE.DryCell("NN1 executor", "b", "NN1"), cuda)
