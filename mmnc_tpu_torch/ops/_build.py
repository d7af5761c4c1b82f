"""Build and load the port's native libraries with ctypes.

CUDA kernels (`mmnc_tpu_torch/csrc/*.cu`) are compiled by `nvcc` for
`sm_90a` into shared libraries with a plain C interface; the rANS coder is
compiled by `g++` from `native/rans/rans.cpp`, the one source the port
shares with the JAX package. Nothing is built when a module is imported:
the first call that needs a library builds it.

Outputs go to `mmnc_tpu_torch/_build/` (gitignored), named by a hash of
the source and the command, so an edited source never loads a stale
library. Each build writes a temporary file and moves it into place with
`os.replace`, so processes that build the same library at once (test
workers) never load a half-written file. `build` starts every missing
compile at once and waits for all of them.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
RANS_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "rans", "rans.cpp")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def kernel_names():
    """Every CUDA source of the port, by stem (`gdn`, `deconv_igdn`, ...)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _spec(name):
    """(command without -o/source, source path) for one library name."""
    if name == "mmncrans":
        return ["g++", *GXX_FLAGS], RANS_SRC
    return [_nvcc(), *NVCC_FLAGS], os.path.join(CSRC_DIR, f"{name}.cu")


def _output_path(name, cmd, src) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(cmd[1:]).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names) -> dict:
    """Compile every library in `names` that is not built yet, all at once.

    Returns {name: path}. Raises with the compiler's output on failure.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, jobs = {}, []
    for name in names:
        cmd, src = _spec(name)
        out = _output_path(name, cmd, src)
        paths[name] = out
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen(cmd + ["-o", tmp, src], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: exit {proc.returncode}\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))
    return paths


def build_all() -> dict:
    """Build every CUDA kernel of the port and the rANS coder together."""
    return build(kernel_names() + ["mmncrans"])


def load(name) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
