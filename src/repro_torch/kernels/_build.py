"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so \
         src/repro_torch/kernels/csrc/<name>.cu

The build lands in `build/repro_torch/` at the repository root (listed in
.gitignore), at first use, from the sources in the repository only. The
library name carries a hash of the source and the flags, so an edited
source rebuilds and a stale library is never loaded. `-fmad=false` (no FMA
contraction) and the default IEEE division are part of the kernels' float32
contract with the Pallas kernels they replace; never add --use_fast_math.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("dse_eval", "lm_kernels")

# argtypes of each library's C entry points: every pointer and the stream
# as c_void_p (a bare int would be cut to 32 bits), every count as c_int,
# every float32 scalar as c_float.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dse_eval": {
        "dse_eval_launch": [_P, _P, _I, _P, _I, _P],
        "dse_search_padded_launch": [_P, _P, _I, _P, _P, _P, _I, _P, _I, _P],
        "dse_search_decoded_launch": [_P, _I, _P, _I, _I, _I, _I, _I, _P,
                                      _P, _P, _I, _P, _I, _P],
        "dse_decode_rows_launch": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _I,
                                   _P],
        "dse_pareto_padded_launch": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _I,
                                     _P, _I, _P],
        "dse_pareto_decoded_launch": [_P, _I, _P, _I, _I, _I, _I, _I, _P,
                                      _P, _I, _I, _I, _P, _I, _P, _I, _P],
    },
    "lm_kernels": {
        "ddot_gemm_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _F, _I, _P],
    },
}

_LOADED: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return found


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lands (content-addressed)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source (or return None if its library exists)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one nvcc per source, all started
    together; returns the wall seconds spent. Raises on a failed build with
    the compiler's output."""
    t0 = time.perf_counter()
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    errors = []
    for proc, tmp, out, cmd in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load_library(name: str = "dse_eval") -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed, with
    the argtypes of its C entry points set."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
