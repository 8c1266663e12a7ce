#!/usr/bin/env python3
"""Phase 18g of chip_smoke.py (Zamba2-1.2B trained in fp32 at full width,
``chip_smoke.fp32_hybrid_train_phase``) on the kernels of one or two
checkouts of the port, on one CUDA card: each checkout's extension is
built in its own ``build/torch_kernels`` (the builds run at once), then
each run is a process of its own that imports ``repro_torch`` from that
checkout's ``src`` and this repository's ``chip_smoke.py`` (the phase's
code is the same for every checkout), in the order given: its dry-run on
meta, the steps held to ``train_launches`` and the dry-run, the profiled
step's shares of K6 and K7 with their backwards, step 1 against the plain
path.

  python3 tools/ab_train_fp32.py ROOT [ROOT ...]

Prints each run's lines, then the card's name and power limit; exits
non-zero if a run fails or there is no card.
"""

from __future__ import annotations

import os
import subprocess
import sys

ME = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(ME))


def worker(root: str, build_only: bool) -> int:
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    # K7's fp32 forward of a checkout from before its 3xTF32 redesign (the
    # CUDA cores), so that its step's shares count it too (K6's old fp32
    # forward, flash_fwd_kernel, is a "flash_fwd" row already)
    cs.K7_ROWS += (("K7 fp32 CUDA-core", "ssd_chunk_kernel"),)

    sys.path.insert(0, os.path.join(root, "src"))   # ahead of this repo's
    import torch

    from repro_torch.kernels import _build

    assert _build.BUILD_DIR.is_relative_to(os.path.realpath(root)), root
    _build.extension()
    if build_only:
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.phase("18g", f"{cs.fp32_train_label()} on the kernels of {root}")
    cs.fp32_hybrid_train_phase(torch, torch.device("cuda", 0), smi)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--worker"]:
        return worker(argv[1], argv[2:] == ["--build"])
    import torch

    if not argv or not torch.cuda.is_available():
        print("ab_train_fp32: give checkouts; a CUDA card is needed",
              file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in argv]
    builds = [subprocess.Popen([sys.executable, ME, "--worker", r, "--build"])
              for r in dict.fromkeys(roots)]
    if any(p.wait() != 0 for p in builds):
        print("ab_train_fp32: a build failed", file=sys.stderr)
        return 1
    for r in roots:
        if subprocess.run([sys.executable, ME, "--worker", r]).returncode:
            print(f"ab_train_fp32: the run on {r} failed", file=sys.stderr)
            return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(out.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
