#!/usr/bin/env python3
"""What ``stream_dispatch`` spends beyond a launch on the card.

Builds, with ``nvcc`` and the port's flags, an empty kernel and kernels of
1,024 threads that each make one or two dependent 4-byte loads
(``j = p[j]``) and one store, then times them with ``stream_dispatch`` in
one ``torch.profiler`` window of 50 rounds.  ``stream_dispatch`` runs at
the 4-shard smoke round's shape (64 valid events, a (1024, 16) out-table,
4,096 timestamps, ``with_early=False``) on inputs drawn from the seed; it
is checked against its plain version bit for bit first.  Prints one JSON
line: each kernel's device ms and its ratio to the empty kernel's.
Needs one CUDA device; fails without one.

    python3 scripts/profile_torch_launch_floor.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(events=64, n_tab=1024, fanout=16, streams=4096)
THREADS = 1024
PROBE_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
// kTrips dependent loads a thread (j = p[j]), then one store
template <int kTrips>
__global__ void chase_kernel(const int* p, int* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int j = i;
  for (int t = 0; t < kTrips; ++t) j = p[j];
  out[i] = j;
}
extern "C" int chase_launch(const void* p, void* out, int n, int trips,
                            void* stream) {
  const int blocks = (n + 255) / 256;
  if (trips == 1)
    chase_kernel<1><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const int*)p, (int*)out, n);
  else
    chase_kernel<2><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const int*)p, (int*)out, n);
  return (int)cudaGetLastError();
}
"""


def build():
    """The probe library, built beside the port's kernels."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "launch_floor"
    out.mkdir(parents=True, exist_ok=True)
    src, lib_path = out / "launch_floor.cu", out / "launch_floor.so"
    src.write_text(PROBE_CU)
    res = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o",
                          str(lib_path), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.chase_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    return lib


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_launch_floor: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.stream_dispatch import kernel as K
    from repro_torch.kernels.stream_dispatch.ops import stream_dispatch
    dev = torch.device("cuda", 0)
    lib = build()
    rng = np.random.default_rng(cs.SEED)
    B, n_tab, F, N = (SHAPE[k] for k in ("events", "n_tab", "fanout",
                                          "streams"))
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    args = (t(rng.integers(0, n_tab, B)), t(rng.integers(0, 1 << 20, B)),
            torch.ones(B, dtype=torch.bool, device=dev),
            t(rng.integers(-1, N, (n_tab, F))),
            t(rng.integers(0, 1 << 20, N)))
    launch, (got, _) = K.plan_stream_dispatch(*args, with_early=False)
    launch()
    want, _ = stream_dispatch(*args, with_early=False, use_kernel=False)
    if not torch.equal(got, want):
        sys.exit("stream_dispatch differs from its plain version")
    stream = _build.stream_ptr(dev)
    chain = ((torch.arange(THREADS, device=dev) * 7 + 1) % THREADS).int()
    chased = torch.empty_like(chain)

    def call(fn, *a):
        def run():
            if fn(*a, stream):
                sys.exit("a probe kernel did not launch")
        return run

    launches = {
        "empty_kernel": call(lib.empty_launch),
        "chase_kernel<1>": call(lib.chase_launch, _build.ptr(chain),
                                _build.ptr(chased), THREADS, 1),
        "chase_kernel<2>": call(lib.chase_launch, _build.ptr(chain),
                                _build.ptr(chased), THREADS, 2),
        "stream_dispatch_kernel": launch}
    cs.time_launches(list(launches.values()), 20)       # warm up
    prof = cs.profile_kernels(list(launches.values()), list(launches))
    if any(v is None for v in prof.values()):
        sys.exit(f"the profiler missed a kernel: {prof}")
    floor = prof["empty_kernel"]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": gpu, "shape": SHAPE, "threads": THREADS,
                      "ms": prof, "x_floor": {k: v / floor
                                              for k, v in prof.items()}}))


if __name__ == "__main__":
    main()
