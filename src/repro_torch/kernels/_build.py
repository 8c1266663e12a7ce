"""Builds the seven CUDA kernels and the backwards of K6 and K7 into one
PyTorch extension at first use.

``torch.utils.cpp_extension.load`` compiles ``csrc/fcnn_fwd.cu``,
``csrc/fcnn_dgrad.cu``, ``csrc/fcnn_fwd_tc.cu``, ``csrc/fcnn_dgrad_tc.cu``,
``csrc/fcnn_wgrad.cu``, ``csrc/fcnn_wgrad_tc.cu``, ``csrc/softmax_xent.cu``,
``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu`` and ``csrc/bindings.cpp``
(headers ``csrc/fcnn_act.cuh``, the activations, ``csrc/fcnn_splitk.cuh``,
the cp.async copies and the cluster reduction of the FCNN kernels,
``csrc/fcnn_tc.cuh``, what K1's, K2's and K3's tensor-core kernels share,
``csrc/hopper_tc.cuh``, the wgmma, descriptor, mbarrier and TMA helpers
of the tensor-core kernels K1/K2 (bf16 weights), K3 (bf16 x), K6, K7 and
their backwards, and ``csrc/ssd_common.cuh``, what K7 and its backward
share) in one
call for ``sm_90a`` into ``build/torch_kernels/`` at the repository root (listed
in ``.gitignore``) and imports the result.  Nothing is built when this
module is imported: the CPU tests import every module of the package and
have no CUDA compiler.
"""

from __future__ import annotations

from pathlib import Path
from types import ModuleType

__all__ = ["extension", "BUILD_DIR", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(str(_CSRC / f)
                for f in ("fcnn_fwd.cu", "fcnn_dgrad.cu", "fcnn_fwd_tc.cu",
                          "fcnn_dgrad_tc.cu", "fcnn_wgrad.cu",
                          "fcnn_wgrad_tc.cu", "softmax_xent.cu",
                          "flash_attention.cu", "flash_attention_bwd.cu",
                          "ssd_scan.cu", "ssd_scan_bwd.cu", "bindings.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

_CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
               "-Xptxas=-v"]

_loaded: dict[str, ModuleType] = {}


def extension(verbose: bool = False) -> ModuleType:
    """The loaded extension, built on the first call of the process.

    ``verbose=True`` on that first call prints the compiler's output,
    including ptxas's registers, shared memory and spills per kernel.
    """
    if "ext" not in _loaded:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _loaded["ext"] = load(
            name="repro_torch_kernels",
            sources=list(SOURCES),
            build_directory=str(BUILD_DIR),
            extra_cflags=["-O2"],
            extra_cuda_cflags=_CUDA_FLAGS,
            verbose=verbose,
        )
    return _loaded["ext"]
