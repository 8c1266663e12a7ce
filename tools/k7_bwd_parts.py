#!/usr/bin/env python3
"""Where the bf16 K7 backward's time goes, by parts cut out: builds
variants of ``csrc/ssd_scan_bwd.cu`` with one part of the bf16 kernel's
head loop removed each, and times them on one CUDA card at chip_smoke.py
phase 7's two training shapes (Zamba2-1.2B's and mamba2-2.7b's, one B/C
group) with the plan's heads a block.

  python3 tools/k7_bwd_parts.py

The parts: ``rows_t`` (the products over rows t: S, dM, ΣdS, the sums of
dS∘S, S∘L's tiles), ``dst`` (dst's hi/lo conversion),
``state`` (F = x·dst and B·dstᵀ), ``dx`` ((S∘L)ᵀ·dy), ``ddt`` (d(dt_a)'s
finish) and ``block`` (the once-a-block dC and dB products), and within
rows_t its exponentials, its column sums and its S∘L stores.  A variant
computes wrong gradients by design: only the full build is held to the
plain version (phase 7's bars).  The times of a variant without a part
are not the part's own time (the compiler schedules what is left anew,
and the other warpgroup may then wait elsewhere): they say which parts the
head loop waits on.  Each variant and a small ``extern "C"`` shim are one
nvcc call (all started together) into ``build/k7_parts/``; the times are
chip_smoke.device_ms's CUDA-graph replay.  Prints one line per variant and
shape, then the card's name and power limit; exits non-zero without a
card or if the full build misses the bars.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k7_parts"

# (name, first line of the cut, first line kept after it (None: the cut is
# the first text alone), replacement)
CUTS = {
    "rows_t": ("    // products over rows t in six units",
               "    // dst into bf16 hi and lo tiles",
               ""),
    "dst": ("    convert_dst<kNT>(sm + Lay::kD, dstate != nullptr, P, N, tq);\n", None, ""),
    "state": ("      // F first, then B·dstᵀ",
              "#pragma unroll\n      for (int e = 0; e < 32; ++e) dx_acc[e] *= w_s",
              "      for (int e = 0; e < 32; ++e) dx_acc[e] = 0.f;\n"),
    "dx": ("#pragma unroll\n      for (int it = 0; it < 2; ++it) {\n"
           "        if (it < g || it >= tiles) continue;\n"
           "        tc::fence_regs(dx_acc);",
           "      store_rows<bf16, 32>(dx", ""),
    "ddt": ("    if (g == 1)  // the warpgroup with fewer of dx's products\n",
            "      finish_ddt_wg(", "    if (false)\n"),
    "block": ("#pragma unroll\n    for (int j = 0; j < 2; ++j) {\n      if (j > g) continue;",
              "    // this block's dB and dC: rows", ""),
    # within rows_t: L's exponentials (and the cs reads), the column sums'
    # shuffles and stores, S∘L's hi/lo stores
    "rows_t exp": ("exp_ex2(cs_t[(e / 2) % 2] - css.x) : 0.f;\n"
                   "          lv[e + 1] = s + 1 <= t && t < Q ? exp_ex2(cs_t[(e / 2) % 2] - css.y)",
                   None, "1.f : 0.f;\n          lv[e + 1] = s + 1 <= t && t < Q ? 1.f"),
    "rows_t cols": ("        float cp2[2];", "        store_hilo(sb + Lay::kW", ""),
    "rows_t W": ("        store_hilo(sb + Lay::kW + (it + j) * 2 * kQTileBytes, sv, "
                 "wr - lane / 4, lane, 4 * hh);", None, ""),
}

SHIM = r'''
#include "{src}"
extern "C" int k7_bwd(const void* x, const float* dt_a, const void* b, const void* c,
                      const void* dy, const float* dstate, const float* ddecay, void* dx,
                      float* ddt, float* part, void* db, void* dc, const long long* st,
                      int BC, int Q, int H, int P, int N, int G, int heads, void* stream) {
  return static_cast<int>(launch_ssd_chunk_bwd(x, dt_a, b, c, dy, dstate, ddecay, dx, ddt,
                                               part, db, dc, st, BC, Q, H, P, N, G, 1, heads,
                                               static_cast<cudaStream_t>(stream)));
}
'''

FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", f"-I{CSRC}", "-D__CUDA_NO_HALF_OPERATORS__",
         "-D__CUDA_NO_HALF_CONVERSIONS__", "-D__CUDA_NO_BFLOAT16_CONVERSIONS__",
         "-D__CUDA_NO_HALF2_OPERATORS__"]


def variants() -> dict[str, str]:
    """{name: source}: the full kernel and one variant a cut."""
    src = (CSRC / "ssd_scan_bwd.cu").read_text()
    out = {"full": src}
    for name, (a, b, repl) in CUTS.items():
        i = src.index(a)
        j = i + len(a) if b is None else src.index(b, i)
        out[f"no {name}"] = src[:i] + repl + src[j:]
    return out


def build() -> dict[str, Path]:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    procs = {}
    for name, text in variants().items():
        stem = name.replace(" ", "_")
        cu = OUT / f"{stem}.cu"
        cu.write_text(text)
        shim = OUT / f"{stem}_shim.cu"
        shim.write_text(SHIM.replace("{src}", str(cu)))
        so = OUT / f"{stem}.so"
        procs[name] = (so, subprocess.Popen([nvcc, *FLAGS, "-o", str(so), str(shim)],
                                            stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = so
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k7_bwd_parts: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import (K7_PATHS, device_ms, k7_bwd_close, k7_bwd_inputs,
                            k7_bwd_noise)
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import bwd_parts_shape, ssd_bwd_plan

    libs = build()
    dev = torch.device("cuda", 0)
    ok = True
    for arch in ("zamba2-1.2b", "mamba2-2.7b"):
        bc, q, h, p, n = K7_PATHS[arch]
        gen = torch.Generator(device=dev).manual_seed(31)
        x, dt_a, b, c, dy, dst, dd = k7_bwd_inputs(torch, dev, gen, (bc, q, h, p, n, 1),
                                                   torch.bfloat16)
        heads = ssd_bwd_plan(bc, h, q, 1, n)
        st = (ctypes.c_longlong * 15)(*[t.stride(d) for t in (x, dt_a, b, c, dy)
                                        for d in range(3)])
        dx = torch.empty_like(x)
        ddt = torch.empty_like(dt_a)
        db = torch.empty((bc, q, 1, n), device=dev, dtype=torch.bfloat16)
        dc = torch.empty_like(db)
        parts = torch.empty(bwd_parts_shape(bc, q, h, n, 1, heads), device=dev)
        base = None
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            fn = lib.k7_bwd
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_void_p] + [ctypes.c_int] * 7 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run(fn=fn):
                err = fn(x.data_ptr(), dt_a.data_ptr(), b.data_ptr(), c.data_ptr(),
                         dy.data_ptr(), dst.data_ptr(), dd.data_ptr(), dx.data_ptr(),
                         ddt.data_ptr(), parts.data_ptr() if parts.numel() else None,
                         db.data_ptr(), dc.data_ptr(), ctypes.addressof(st), bc, q, h, p,
                         n, 1, heads, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
                return dx, ddt, db, dc

            run()
            torch.cuda.synchronize()
            note = ""
            if name == "full":
                want = ref.ssd_chunk_bwd_ref(x, dt_a, b, c, dy, dst, dd, 1)
                good, _, crit = k7_bwd_close(torch, run(), want,
                                             k7_bwd_noise(x, b, c, dy, dst, dd))
                ok = ok and good
                note = f" ({crit}; {'ok' if good else 'FAIL'})"
            ms = device_ms(run, iters=5, replays=5)
            base = ms if name == "full" else base
            print(f"{arch} (16,128,{h},64,{n}) heads {heads} {name:9s} device ms {ms:.5f} "
                  f"({ms - base:+.5f} against full){note}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: none")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
