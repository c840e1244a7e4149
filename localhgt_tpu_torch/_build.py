"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on first use
into `build/localhgt_tpu_torch/<name>-<sha>.so` beside the package, where
`<sha>` hashes the source and the flags, so an edited source rebuilds and
an unchanged one loads the existing library. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "localhgt_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def library_path(name: str, extra_flags: tuple = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join([*NVCC_FLAGS, *extra_flags])
    key = hashlib.sha1(src + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str, extra_flags: tuple = ()) -> Path:
    """Compile csrc/<name>.cu unless its content-keyed library exists.

    extra_flags: more nvcc flags (`-D...` of a tuning run, `-Xptxas -v`);
    the package's own loads pass none."""
    so = library_path(name, extra_flags)
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{res.stderr}")
    if "-v" in extra_flags:  # ptxas reports registers and spills on stderr
        print(res.stderr, flush=True)
    os.replace(tmp, so)
    return so


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library.

    signatures: {c_function_name: [ctypes argument types]}; every entry
    point returns the int value of cudaGetLastError()."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
