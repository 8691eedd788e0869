"""Build the port's CUDA kernels, and the prerequisites of the host engine.

Kernels: every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ctypes at first use.
The library's name carries a hash of the sources, so an edited source is
rebuilt and a stale build is never loaded (as ``sz3_tpu/native/build.py``
does for the host engine). Nothing is built when a module is imported.

Host engine: ``sz3_tpu.runtime`` compiles its C++ engine with ``g++ -lzstd``
at first use. Some machines carry zstd's runtime library (``libzstd.so.1``)
but not its development files (``zstd.h``, the ``libzstd.so`` link). For
those, :func:`host_engine` retries the build with ``csrc/zstd/zstd.h`` (the
declarations of the six zstd functions the engine calls) on the include path
and a ``libzstd.so`` link to the installed runtime library on the link path.
The engine then links the machine's own zstd, so archives stay the ones the
engine writes everywhere else.
"""

from __future__ import annotations

import ctypes as C
import glob
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[C.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _tree_hash() -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for f in cu + cuh + [Path(__file__)]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def kernel_lib_path() -> Path:
    return BUILD_DIR / f"libszt_cuda-{_tree_hash()}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def build_kernels(verbose: bool = False) -> Path:
    """Compile the kernels unless a build of the current sources exists.
    With ``verbose``, ptxas reports each kernel's registers and shared memory."""
    out = kernel_lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(s) for s in cu)]
    if verbose:
        print("nvcc:", " ".join(cmd), flush=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed:\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, flush=True)
    os.replace(tmp, out)
    for old in BUILD_DIR.glob("libszt_cuda-*.so"):
        if old != out:
            old.unlink(missing_ok=True)
    return out


def kernels() -> C.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = C.CDLL(str(build_kernels()))
        p, i32, i64 = C.c_void_p, C.c_int, C.c_longlong
        lib.szt_hist_count.restype = i32
        lib.szt_hist_count.argtypes = [p, i64, i32, i32, i64, i32, p, p, p]
        lib.szt_literal_slots.restype = i32
        lib.szt_literal_slots.argtypes = [p, i64, i64, i32, p, p, p]
        lib.szt_pack_bits.restype = i32
        lib.szt_pack_bits.argtypes = [p, i64, i32, p, p, i64, i32, p, i64, p, p]
        _lib = lib
    return _lib


# ---- host engine ---------------------------------------------------------------

_ZSTD_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/usr/lib/aarch64-linux-gnu",
                  "/usr/lib64", "/usr/lib", "/lib/x86_64-linux-gnu", "/usr/local/lib")


def _zstd_runtime_library() -> str:
    dirs = [d for d in os.environ.get("LD_LIBRARY_PATH", "").split(":") if d]
    for d in dirs + list(_ZSTD_LIB_DIRS):
        hits = sorted(glob.glob(os.path.join(d, "libzstd.so.1*")))
        if hits:
            return hits[0]
    raise RuntimeError("the host engine needs zstd: neither zstd.h nor libzstd.so.1 "
                       "was found")


def _prepend(var: str, path: str) -> None:
    old = os.environ.get(var)
    os.environ[var] = path if not old else f"{path}{os.pathsep}{old}"


def host_engine():
    """``sz3_tpu.runtime`` with its C++ engine built (see the module note)."""
    from sz3_tpu import runtime

    try:
        runtime.lib()
    except RuntimeError as e:
        if "zstd.h" not in str(e):
            raise
        link_dir = BUILD_DIR / "zstd_link"
        link_dir.mkdir(parents=True, exist_ok=True)
        link = link_dir / "libzstd.so"
        if link.is_symlink() or link.exists():
            link.unlink()
        link.symlink_to(_zstd_runtime_library())
        saved = {v: os.environ.get(v) for v in ("CPLUS_INCLUDE_PATH", "LIBRARY_PATH")}
        try:
            _prepend("CPLUS_INCLUDE_PATH", str(CSRC / "zstd"))
            _prepend("LIBRARY_PATH", str(link_dir))
            runtime.lib()
        finally:
            for v, old in saved.items():
                if old is None:
                    os.environ.pop(v, None)
                else:
                    os.environ[v] = old
    return runtime
