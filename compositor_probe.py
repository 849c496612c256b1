#!/usr/bin/env python3
"""Where the tile compositor's time goes on one NVIDIA GPU: B3 and B4 on
camera 0 of chip_smoke.py's render cell, timed as built and with parts of
their work taken out.

    python3 compositor_probe.py [--out DIR]

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
Each probe build is a copy of csrc/composite_fwd.cu or composite_bwd.cu
(with csrc/composite_tiles.cuh) in which thread 0 of every CTA records
%globaltimer at its start and end and %smid, so that a launch gives each
tile's duration. Probes: as built; without the exp pretest; "power only"
(every pixel leaves a pair after its exponent: the staging, the loop and
the power); B4 without its reduce. For each mode (B3 without and with the
store, B4 replaying and stored) it prints the ms per call (CUDA events
around one call), the ms per call with 20 calls back to back, the CTAs
resident over the middle of the kernel's span, the fit of a tile's
duration against its pair count, and the share of the span in which fewer
than 90% of that residency remain (the last partial wave). The probe
results are not correct gradients or images: they time parts of the work.
The SASS of the builds as they ship goes to DIR (default
build/compositor_probe/).
Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "sixdgs_torch", "csrc")
WORK = os.path.join(HERE, "build", "compositor_probe")
PROFILE = r'''
#include <cuda_runtime.h>
__device__ unsigned long long g_prof[3 * 65536];
__device__ __forceinline__ unsigned long long probe_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE_BEGIN unsigned long long probe_t0 = probe_time();
#define PROBE_END if (threadIdx.x == 0) { unsigned sm; \
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); g_prof[3 * blockIdx.x] = probe_t0; \
  g_prof[3 * blockIdx.x + 1] = probe_time(); g_prof[3 * blockIdx.x + 2] = sm; }
extern "C" int probe_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, (size_t)n * 24);
}
'''
# (text in the source, its replacement)
COUNT = "  const int count = counts[t];\n"
OUT = "#pragma unroll\n  for (int q = 0; q < PPT; ++q) {\n    float* o = out"
LAST = "  cp_async_wait_all();  // no copy outlives the CTA\n"
TIMED = {
    "composite_fwd": [(COUNT, COUNT + "  PROBE_BEGIN\n"), (OUT, "PROBE_END\n" + OUT)],
    "composite_bwd": [(COUNT, COUNT + "  PROBE_BEGIN\n"), (LAST, LAST + "  PROBE_END\n")],
}
TEST = "  if (!(power <= 0.f) || power < pb.y) return;"
PROBES = {
    "as built": [],
    "no exp pretest": [(TEST, "  if (!(power <= 0.f)) return;")],
    "power only": [(TEST, "  if (power != 12345.f) return;")],
    "no reduce": [("    if (rj < n) {", "    if (false) {")],
}


def build(name: str, probe: str):
    """The probe build of csrc/<name>.cu, loaded, with the wrapper's C
    signature; None where the probe does not apply to the source."""
    from sixdgs_torch.ops import _build
    from sixdgs_torch.ops.rasterizer import pallas_tiles as pt

    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    for old, new in TIMED[name] + PROBES[probe]:
        if old not in src:
            return None
        src = src.replace(old, new, 1)
    d = os.path.join(WORK, f"{name}-{probe.replace(' ', '_')}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "k.cu"), "w") as f:
        f.write(PROFILE + src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-o",
                           os.path.join(d, "k.so"), os.path.join(d, "k.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name} ({probe}):\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(os.path.join(d, "k.so"))
    (fname, (restype, argtypes)), = pt._SIGNATURES[name].items()
    fn = getattr(lib, fname)
    fn.restype, fn.argtypes = restype, argtypes
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib, fn


def timeline(cs, lib, call, counts) -> str:
    """One launch's per-tile durations against the pair counts, and the
    call's times."""
    ms = cs.cuda_ms(call, reps=10)
    b2b = cs.cuda_ms_back_to_back(call)
    call()
    torch.cuda.synchronize()
    n = len(counts)
    buf = np.zeros(3 * n, np.uint64)
    if lib.probe_read(buf.ctypes.data, n) != 0:
        raise RuntimeError("reading the probe's timeline failed")
    b = buf.reshape(-1, 3).astype(np.float64)
    t0 = b[:, 0].min()
    start, end = (b[:, 0] - t0) / 1e3, (b[:, 1] - t0) / 1e3
    dur, span = end - start, end.max()
    grid = np.linspace(0.0, span, 201)
    resident = np.array([((start <= g) & (end > g)).sum() for g in grid])
    full = np.median(resident[40:161])
    tail = 1.0 - grid[np.nonzero(resident >= 0.9 * full)[0][-1]] / span
    a, slope = np.linalg.lstsq(np.stack([np.ones(n), counts], 1), dur, rcond=None)[0]
    corr = np.corrcoef(dur, counts)[0, 1]
    return (f"{ms:.4f} ms per call, {b2b:.4f} back to back; span {span:.1f} us, "
            f"{full:.0f} CTAs resident ({full / len(set(b[:, 2])):.1f} per SM), last partial "
            f"wave {100 * tail:.0f}% of the span; tile = {a:.2f} us + {slope:.4f} us per pair "
            f"(correlation {corr:.3f})")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=WORK)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compositor_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from sixdgs_torch.ops import _build
    from sixdgs_torch.ops.rasterizer import pallas_tiles as pt
    from sixdgs_torch.scene.gaussians import from_arrays

    jobs = [(name, probe) for name in TIMED for probe in PROBES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda job: build(*job), jobs)))

    scene = from_arrays(cs.random_scene_arrays(np.random.default_rng(cs.SEED)),
                        max_sh_degree=3, device="cuda")
    _, lay, _ = cs.layout_of(scene, cs.render_cameras()[0])
    gidx_al = pt._align_compact(lay.gidx_c, lay.starts, lay.starts_al, lay.n_tiles, lay.P)
    rec = pt._gather_records(lay, gidx_al).detach()
    bg = torch.tensor(cs.RENDER_BG, device="cuda")
    starts, counts = lay.starts_al, lay.counts_k
    n_tiles, nc, nx = lay.n_tiles, lay.nc, lay.nx
    out, tex = pt.pallas_composite_fwd(rec, starts, counts, nx, lay.ny, bg, store_t=True)
    dout = torch.randn(out.shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(cs.SEED))
    count_np = counts.cpu().numpy().astype(np.float64)
    print(f"camera 0: {n_tiles} tiles, pairs per tile mean {count_np.mean():.1f}, "
          f"max {int(count_np.max())}", flush=True)

    for (name, probe), res in libs.items():
        if res is None:
            continue
        lib, fn = res
        if name == "composite_fwd":
            for store in (False, True):
                def call(fn=fn, store=store):
                    o = torch.empty(n_tiles, 256, 3, device="cuda")
                    tx = torch.empty(nc // 128, 256, 128, device="cuda") if store else None
                    _build.launch(fn, rec, nc, starts, counts, n_tiles, nx, bg, o, tx)
                label = "B3 with the store" if store else "B3"
                print(f"{label}, {probe}: {timeline(cs, lib, call, count_np)}", flush=True)
        else:
            for stored in (False, True):
                def call(fn=fn, stored=stored):
                    g = torch.zeros(16, nc, device="cuda")
                    _build.launch(fn, rec, nc, starts, counts, n_tiles, nx, out, dout,
                                  tex if stored else None, g)
                label = "B4 stored" if stored else "B4 replay"
                print(f"{label}, {probe}: {timeline(cs, lib, call, count_np)}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in TIMED:
        _build.build(name)
        sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, check=True).stdout
        with open(os.path.join(args.out, f"{name}.sass"), "w") as f:
            f.write(sass)
    print(f"SASS of the builds as they ship: {args.out}/composite_{{fwd,bwd}}.sass")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
