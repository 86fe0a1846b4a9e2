"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``kernels/<name>/csrc/*.cu`` is compiled on first use into its own
shared library with a plain C interface (the headers they share are in
``kernels/csrc/``), under ``build/repro_torch_kernels/``
at the root of the checkout (``.gitignore`` lists ``build/``).  All sources
are compiled at once, one ``nvcc`` process each, started together.  A
library's file name carries a hash of its sources and flags, so an
unchanged source is not rebuilt within one checkout.

The flags are part of the kernels' float contract (see
``core/program.py``): ``-ftz=true`` (subnormals flush, as XLA on the CPU
flushes them), ``-fmad=false`` (no FMA contraction) and never
``--use_fast_math``.

Nothing here runs at import time: this module is imported by the CPU
tests, where there is no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ["-std=c++17", "-O3", ARCH, "-fmad=false", "-ftz=true",
         "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None   # wall time of the last build
build_log: Dict[str, str] = {}          # nvcc's output per source


def sources() -> List[Path]:
    """Every CUDA source of the port, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for f in [src, *sorted(KERNELS_DIR.glob("*/csrc/*.cuh")),
              *sorted(KERNELS_DIR.glob("csrc/*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(verbose_ptxas: bool = False) -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes started together; raise with nvcc's output if any fails.
    ``verbose_ptxas`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel, kept in :data:`build_log`).  Returns the library
    path per kernel source stem."""
    global build_seconds
    extra = ["-Xptxas", "-v"] if verbose_ptxas else []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    targets = {src.stem: (src, _target(src)) for src in sources()}
    procs = {}
    for stem, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[stem] = (subprocess.Popen(
            [_nvcc(), *FLAGS, *extra, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return {stem: out for stem, (_, out) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built on first use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        paths = build_all()
        if stem not in paths:
            raise KeyError(f"no CUDA source named {stem}.cu")
        lib = _LIBS[stem] = ctypes.CDLL(str(paths[stem]))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
