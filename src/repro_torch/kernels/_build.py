"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xptxas -v -shared -Xcompiler -fPIC \
         -o build/repro_torch/lib<name>-<hash>.so \
         src/repro_torch/kernels/csrc/<name>.cu

The build lands in `build/repro_torch/` at the repository root (listed in
.gitignore), at first use, from the sources in the repository only, with
the compiler's output (ptxas's registers, shared memory and spills of each
kernel) beside it in `lib<name>-<hash>.log`. The library name carries a
hash of the source and its flags, so an edited source rebuilds and a stale
library is never loaded. `-fmad=false` (no FMA contraction) and the default
IEEE division are part of the float32 contract of the DSE and DDot kernels
with the Pallas kernels they replace, which they equal bit for bit; never
add --use_fast_math. The two attention sources, held to a tolerance, build
without `-fmad=false` (`FLAGS`).

The slab scheduler's worker threads launch kernels concurrently, so loading
(and building) a library happens under one lock, each nvcc run writes to a
temporary file of its own thread, and the wrappers count their launches
through `count_launch`, under a lock too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")
SOURCES = ("dse_eval", "lm_kernels", "flash_attention",
           "flash_attention_tf32")
_TOLERANT = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
#: nvcc flags of each source: the exact sources keep NVCC_FLAGS.
FLAGS = {"dse_eval": NVCC_FLAGS, "lm_kernels": NVCC_FLAGS,
         "flash_attention": _TOLERANT, "flash_attention_tf32": _TOLERANT}

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
        "dse_search_split": [],
        "dse_decode_rows_launch": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _I,
                                   _P],
        "dse_pareto_padded_launch": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _I,
                                     _P, _I, _P],
        "dse_pareto_decoded_launch": [_P, _I, _P, _I, _I, _I, _I, _I, _P,
                                      _P, _I, _I, _I, _P, _I, _P, _I, _P],
        "dse_pareto_smem_bytes": [_I, _I],
    },
    "lm_kernels": {
        "ddot_gemm_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "flash_attention": {
        "flash_attention_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _F, _P],
    },
    "flash_attention_tf32": {
        "flash_attention_tf32_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _F, _I, _I, _P, _P],
        "flash_attention_tf32_smem_bytes": [_I],
    },
}

_LOADED: dict = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(counts: dict, name: str) -> None:
    """Add one launch of kernel `name` to `counts` (a kernel module's
    `LAUNCHES`); the read-modify-write happens under a lock, as worker
    threads launch concurrently."""
    with _COUNT_LOCK:
        counts[name] += 1


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
    h.update(" ".join(FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source (or return None if its library exists)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *FLAGS[name], "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out, cmd


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc per source, all started
    together; returns the wall seconds from the common start to each
    source's end (0.0 for a library that was already built). Raises on a
    failed build with the compiler's output."""
    t0 = time.perf_counter()
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    seconds = {n: 0.0 for n in names}
    errors = []
    for name, proc, tmp, out, cmd in jobs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return seconds


def load_library(name: str = "dse_eval") -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed, with
    the argtypes of its C entry points set. Threads that ask at once wait
    for one build and one load."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
    return lib
