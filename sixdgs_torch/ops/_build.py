"""Build the port's CUDA sources with nvcc and load them with ctypes.

``csrc/<name>.cu`` becomes ``build/torch_kernels/<name>-<hash>.so`` at
first use, keyed on a hash of the source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. ``defines`` (``NAME=value``
strings, passed as ``-D``) build a variant of a source beside its default
build, as chip_smoke.py does to time a kernel's compile-time choices. The
sources include no PyTorch header and export a plain C interface, which
keeps a build to seconds. Nothing here runs at import time: this module is
imported on machines that have neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from sixdgs_torch.utils.profiling import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(defines: tuple = ()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _lib_path(name: str, defines: tuple = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str, defines: tuple = ()) -> float:
    """Compile ``csrc/<name>.cu`` unless its library is current. Returns the
    wall seconds of the build (0.0 where the library was already current)
    and raises with nvcc's output when it fails. ptxas's register and
    shared-memory report goes to ``<lib>.log`` beside the library."""
    out = _lib_path(name, defines)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    with span("setup.kernel_build"):
        proc = subprocess.run([_nvcc(), *_flags(defines), "-o", str(tmp),
                               str(CSRC / f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out.with_suffix(".log").write_bytes(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n"
                           + proc.stdout.decode(errors="replace"))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    count("kernel.builds")
    return time.perf_counter() - t0


def library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """``csrc/<name>.cu`` loaded, built first if needed; counted as
    ``kernel.loads`` (and a build as ``kernel.builds``)."""
    build(name, defines)
    count("kernel.loads")
    return ctypes.CDLL(str(_lib_path(name, defines)))


_bound = {}


def bound_library(name: str, signatures: dict) -> ctypes.CDLL:
    """``csrc/<name>.cu``, built and loaded at first use, with the C
    signatures ``{function: (restype, argtypes)}`` set once."""
    if name not in _bound:
        lib = library(name)
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _bound[name] = lib
    return _bound[name]


def launch(fn, *args) -> None:
    """Call the C launcher ``fn`` on the current stream of the first
    argument's device: tensors go as their data pointers, the stream last.
    Raises when it returns a CUDA error (a launch the card refused)."""
    import torch

    dev = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if dev.index == torch.cuda.current_device():  # no device switch: host work is the cost
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
