#!/usr/bin/env python3
"""Where the cycles of one scheduler pop go on the card.

Copies ``sched_pop/csrc/pop_select.cuh`` into ``build/pop_profile/`` with
a read of the SM cycle counter after every CTA barrier (thread 0 stores
it), builds one kernel that runs the pop on it with ``nvcc``, and runs it
on chip_smoke's adversarial queue planes (16 tenants).  Prints, per
queue size, the cycles between consecutive barriers under the phase
names of ``pop_select::run`` (load, the first sort's register runs and
merge levels, the rank scan, the tags, the second sort's words, runs and
levels, the take), and checks the popped slots against the plain pop.
Needs one CUDA device; fails without one.

    python3 scripts/profile_torch_pop.py [--queue 2048 100] [--batch 64]
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "src/repro_torch/kernels/sched_pop/csrc/pop_select.cuh"
STAMP = ("__syncthreads(); "
         "if (threadIdx.x == 0) g_stamp[g_n++] = clock64();")
KERNEL = r"""
#include "pop_select.cuh"
__global__ void __launch_bounds__(pop_select::kThreads) pop_profile_kernel(
    const int* prio, const int* seq, const uint8_t* valid, const int* tenant,
    const int* weight, int Q, int B, int* take) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (threadIdx.x == 0) { g_n = 0; g_stamp[g_n++] = clock64(); }
  const pop_select::Planes p = pop_select::carve(smem, Q, B);
  pop_select::run(p, Q, B, prio, seq, valid, tenant, weight);
  for (int b = threadIdx.x; b < B; b += blockDim.x) take[b] = p.take[b];
}
extern "C" int pop_profile(const void* prio, const void* seq,
                           const void* valid, const void* tenant,
                           const void* weight, int Q, int B, void* take,
                           long long* stamps, int* n) {
  const size_t smem = pop_select::planes_bytes(Q, B);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)pop_profile_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pop_profile_kernel<<<1, pop_select::threads_for(Q), smem>>>(
      (const int*)prio, (const int*)seq, (const uint8_t*)valid,
      (const int*)tenant, (const int*)weight, Q, B, (int*)take);
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbol(n, g_n, sizeof(int));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(stamps, g_stamp, sizeof(long long) * 256);
}
"""


def build():
    """The stamped copy of the header and its kernel, built with the
    port's nvcc flags; returns the loaded library."""
    from repro_torch.kernels import _build
    src = HEADER.read_text()
    tile = int(src.split("constexpr int kTile = ")[1].split(";")[0])
    out = _build.BUILD_DIR.parent / "pop_profile"
    out.mkdir(parents=True, exist_ok=True)
    (out / "pop_select.cuh").write_text(src.replace(
        "namespace pop_select {", "__device__ long long g_stamp[256];\n"
        "__device__ int g_n;\nnamespace pop_select {", 1).replace(
        "__syncthreads();", STAMP))
    (out / "pop_profile.cu").write_text(KERNEL)
    lib_path = out / "pop_profile.so"
    res = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(lib_path),
                          str(out / "pop_profile.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.pop_profile.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p] * 3
    return lib, tile


def phase_names(Q: int, B: int, tile: int, threads: int):
    """The barriers of ``pop_select::run`` in order, for a Q-slot queue."""
    levels = max(0, math.ceil(math.log2(math.ceil(Q / tile))))
    rounds = math.ceil(Q / (threads * tile))
    sort = ["runs"] + [f"merge w={tile << i}" for i in range(levels)]
    return (["load"] + [f"sort 1 {s}" for s in sort]
            + [f"rank scan {i // 2}" for i in range(2 * rounds)]
            + ["tags", "sort 2 words"] + [f"sort 2 {s}" for s in sort]
            + ["take"])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queue", type=int, nargs="+", default=[2048, 100])
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_pop: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from chip_smoke import nvidia_smi, queue_case
    from repro_torch.kernels.sched_pop.kernel import check_fits
    from repro_torch.kernels.sched_pop.ref import sched_pop_ref
    lib, tile = build()
    print(f"[card] {nvidia_smi()}")
    for Q in args.queue:
        B = min(args.batch, Q)
        check_fits(Q, B)
        planes = [torch.from_numpy(a).cuda() for a in
                  queue_case(np.random.default_rng(Q), Q, 1, 16, 4096)[:5]]
        planes[2] = planes[2].to(torch.uint8)
        want = sched_pop_ref(*planes[:2], planes[2].bool(), *planes[3:],
                             B).cpu().numpy()
        take = torch.zeros(B, dtype=torch.int32, device="cuda")
        stamps = (ctypes.c_longlong * 256)()
        n = ctypes.c_int()
        for _ in range(3):                 # the last of three launches
            err = lib.pop_profile(*[ctypes.c_void_p(t.data_ptr())
                                    for t in planes], Q, B,
                                  ctypes.c_void_p(take.data_ptr()), stamps,
                                  ctypes.byref(n))
            if err != 0:
                sys.exit(f"profile_torch_pop: CUDA error {err}")
        if not np.array_equal(take.cpu().numpy(), want):
            sys.exit(f"profile_torch_pop: Q={Q} pop differs from the plain "
                     "version")
        st = np.array(stamps[:n.value])
        threads = min(512, max(32, math.ceil(Q / (32 * tile)) * 32))
        names = phase_names(Q, B, tile, threads)
        cycles = np.diff(st).tolist()
        if len(cycles) != len(names):
            names = [f"phase {i}" for i in range(len(cycles))]
        print(f"[pop] Q={Q} B={B}: {int(st[-1] - st[0])} cycles from the "
              f"first stamp to the last barrier; equal to the plain pop")
        for name, c in zip(names, cycles):
            print(f"[pop]   {name}: {c}")


if __name__ == "__main__":
    main()
