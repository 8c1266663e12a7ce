"""Run one cell of the benchmark once (``bench/harness.py`` says how).

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Every cache the run builds stays in the
checkout: the port's kernels in ``build/torch_kernels`` (the program fixes
that directory; a ``lock`` left there by a run that was cut off is
removed), PyTorch's extension and Triton caches in ``build/``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _prepare() -> bool:
    """Paths and caches; False where the checkout holds no program."""
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"no program under {src}", file=sys.stderr)
        return False
    sys.path[:0] = [str(ROOT), str(src)]
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    (build / "torch_kernels" / "lock").unlink(missing_ok=True)
    return True


if __name__ == "__main__":
    if not _prepare():
        sys.exit(2)
    from bench.harness import main

    sys.exit(main(t_start=T_START))
