"""Build and load the hand-written CUDA kernels (nvcc → .so → ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into ``build/kernels/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so

The file name carries a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header is rebuilt and a
stale library is never loaded.  ``build_all`` starts one
``nvcc`` per source at once.  Nothing is compiled when this module is
imported; hosts without ``nvcc`` can import it and never call it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("bfs_multi", "fm_fused", "sep_gain", "ell_spmv", "diffusion",
           "matching", "dgraph")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# ctypes signatures of the C entries: every pointer and the stream are
# c_void_p, every count a c_int, every scalar a c_float; each entry returns
# cudaGetLastError().
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "bfs_multi": {"bfs_multi_launch": [_P] * 4 + [_I] * 4 + [_P],
                  "bfs_cluster_launch": [_P] * 4 + [_I] * 5 + [_P]},
    "fm_fused": {"fm_fused_launch": [_P] * 15 + [_I] * 7 + [_P],
                 "fm_move_loop_launch": [_P] * 19 + [_I] * 6 + [_P]},
    "sep_gain": {"sep_gain_launch": [_P] * 7 + [_I] * 5 + [_P]},
    "ell_spmv": {"ell_spmv_launch": [_P] * 4 + [_I] * 3 + [_P]},
    "diffusion": {"diffusion_launch": [_P] * 5 + [_I] * 2 + [_F] * 2 + [_P]},
    "matching": {"matching_grid_launch": [_P] * 5 + [_I] * 4 + [_P],
                 "matching_cluster_launch": [_P] * 5 + [_I] * 5 + [_P]},
    "dgraph": {"empty_launch": [_P],
               "ell_relax_launch": [_P] * 3 + [_I] * 5 + [_P],
               "halo_parts_launch": [_P] * 3 + [_I] * 6 + [_P],
               "dbfs_parts_init_launch": [_P] * 5 + [_I] * 6 + [_P],
               "dbfs_parts_step_launch": [_P] * 4 + [_I] * 7 + [_P],
               "dmatch_parts_launch": [_P] * 15 + [_I] * 10 + [_P] * 2,
               "dbfs_launch": [_P] * 7 + [_I] * 6 + [_P] * 2,
               "dbfs_cluster_launch": [_P] * 7 + [_I] * 7 + [_P] * 2,
               "dmatch_launch": [_P] * 8 + [_I] * 7 + [_P] * 2,
               "dmatch_cluster_launch": [_P] * 8 + [_I] * 8 + [_P] * 2},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def _compile_cmd(name: str, out: Path) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns the compiler's messages (``-Xptxas -v`` register and shared
    memory counts) per source that was compiled now.  Raises with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
