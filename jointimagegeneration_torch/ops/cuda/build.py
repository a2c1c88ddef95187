"""Build the port's native sources and load them with ctypes.

Each source under `jointimagegeneration_torch/csrc/` is compiled on first use
into a shared library with a plain C interface.  A CUDA source (`.cu`) with
nvcc:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

and a host C++ source (`.cc`, the data route's `nifti_native.cc`) with the
host compiler, `$CXX` or else `c++`:

    c++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared \
        -o build/kernels/<name>-<hash>.so csrc/<name>.cc -lz

The library lands in `build/kernels/` at the root of the checkout (listed in
`.gitignore`).  Its file name carries a hash of the source, the shared headers
(`csrc/*.cuh`, for a CUDA source), the compiler and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Each compile writes a
file of its own and renames it into place, so processes that build the same
library at once never load half a file.  Nothing is imported or compiled when
this module is imported.
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
from typing import Dict, Sequence

__all__ = ["CSRC_DIR", "BUILD_DIR", "nvcc_path", "cxx_path", "build_all", "load_library"]

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")
CXX_LIBS = ("-lz",)

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # the loader's threads may ask for a library at once


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def cxx_path() -> str:
    """The host C++ compiler: `$CXX`, else `c++`."""
    return os.environ.get("CXX") or "c++"


def _is_host(name: str) -> bool:
    return (CSRC_DIR / f"{name}.cc").exists()


def _command(name: str, out: Path) -> list:
    if _is_host(name):
        return [cxx_path(), *CXX_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cc"), *CXX_LIBS]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def _library_path(name: str) -> Path:
    if _is_host(name):
        h = hashlib.sha256((CSRC_DIR / f"{name}.cc").read_bytes())
        h.update(" ".join((cxx_path(), *CXX_FLAGS, *CXX_LIBS)).encode())
    else:
        h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode())
        for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared headers the source may include
            h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, one
    compiler process per source, all started together.  Returns {name:
    seconds each compile took} for the sources compiled.  Raises with the
    compiler's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, failures = {}, []
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = _command(name, tmp)
        try:
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        except OSError as e:
            failures.append(f"{cmd[0]} could not be started to build {name} ({e})")
    done = {}

    def wait(name, proc):
        log, _ = proc.communicate()
        done[name] = (time.perf_counter() - t0, log)

    waiters = [threading.Thread(target=wait, args=(name, proc)) for name, (proc, _, _) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for name, (proc, tmp, out) in procs.items():
        if proc.returncode != 0:
            failures.append(f"{Path(proc.args[0]).name} failed for {name} (rc {proc.returncode}): "
                            f"{' '.join(proc.args)}\n{done[name][1]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: seconds for name, (seconds, _) in done.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` or `.cc`, building it first if
    needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(_library_path(name)))
    return lib
