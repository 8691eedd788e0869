"""Build the port's native code at first use: the CUDA kernels and the C++
host engine. Nothing is built when a module is imported.

Kernels: every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together) and linked into one shared
library with a plain C interface, loaded with ctypes. ``-fmad=false`` keeps
float arithmetic rounding once per operation, as the host engine's build does.

Host engine: ``csrc/engine/`` (the port's copy of the sources under
``sz3_tpu/native/``) is compiled by ``g++`` into one shared library that
``runtime.py`` binds with ctypes. ``-ffp-contract=off`` keeps scalar float
expressions IEEE-exact per operation (no FMA fusion), which the archives'
bit parity with the reference codec depends on; ``-march=native`` is then
safe and buys vector width for the quantizer loops. The engine links zstd.
Some machines carry zstd's runtime library (``libzstd.so.1``) but not its
development files (``zstd.h``, the ``libzstd.so`` link); there the build
takes ``csrc/zstd/zstd.h`` (the declarations of the zstd functions the
engine calls) and a ``libzstd.so`` link to the installed runtime library,
both named on the compiler's command line. The engine then links the
machine's own zstd, so archives stay the ones the engine writes everywhere
else.

HDF5 filter plugin: ``csrc/h5z_szt.cpp`` (the port's copy of
``sz3_tpu/native/h5z_szt.cpp``) over the engine's headers, compiled by
``g++`` with the engine's flags and zstd as above (``build_h5z``).

The libraries go to ``_build/`` under a name that carries a hash of their
sources, so an edited source is rebuilt and a stale build is never loaded. A
build writes to a temporary name and renames, under a file lock, so that
processes that start together build once.
"""

from __future__ import annotations

import contextlib
import ctypes as C
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
ENGINE_SRC = CSRC / "engine"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no multiply-add contraction, so float kernels round once per
# operation as the host engine's -ffp-contract=off build does (archive parity).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-march=native",
            "-funroll-loops", "-ffp-contract=off", "-Wall"]

_lib: Optional[C.CDLL] = None


def _hash(files: List[Path], flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _build_lock(name: str):
    """Exclusive lock on ``_build/.<name>.lock`` for the time of a build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _drop_stale(pattern: str, keep: Path) -> None:
    for old in BUILD_DIR.glob(pattern):
        if old != keep:
            old.unlink(missing_ok=True)


# ---- CUDA kernels ---------------------------------------------------------------

def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def kernel_lib_path() -> Path:
    cu, cuh = _sources()
    return BUILD_DIR / f"libszt_cuda-{_hash(cu + cuh, NVCC_FLAGS)}.so"


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
    nvcc = _nvcc()
    with _build_lock("kernels"):
        if out.exists():
            return out
        cu, _ = _sources()
        tag = f"{out.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cu]
        cmds = [[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", "-o",
                 str(o), str(s)]
                for s, o in zip(cu, objs)]
        try:
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for c in cmds]
            logs = [p.communicate()[1] for p in procs]
            for s, p, log in zip(cu, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"CUDA kernel build failed ({s.name}):\n{log}")
                if verbose and log:
                    print(f"nvcc {s.name}:\n{log}", flush=True)
            tmp = BUILD_DIR / f"{tag}.tmp"
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"CUDA kernel link failed:\n{link.stderr}")
            os.replace(tmp, out)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        _drop_stale("libszt_cuda-*.so", out)
    return out


def kernels() -> C.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = C.CDLL(str(build_kernels()))
        p, i32, i64 = C.c_void_p, C.c_int, C.c_longlong
        lib.szt_hist_count.restype = i32
        lib.szt_hist_count.argtypes = [p, i64, i32, i32, i32, p, p, p]
        lib.szt_literal_slots.restype = i32
        lib.szt_literal_slots.argtypes = [p, i64, i32, p, p, p]
        lib.szt_pack_bits.restype = i32
        lib.szt_pack_bits.argtypes = [p, i64, i32, p, p, p, i64, i32, p, i64, p, p]
        lib.szt_huff_scan.restype = i32
        lib.szt_huff_scan.argtypes = [p, i64, i64, i64, i64, i32, i32, p, p, p, p, p, i32, p,
                                      i32, p, p, p, p, p]
        lib.szt_huff_write.restype = i32
        lib.szt_huff_write.argtypes = [p, i64, i64, i32, p, p, p, i64, i32, p, p, p, p, p, i32,
                                       p, p, p, p]
        lib.szt_lorenzo_sweep.restype = i32
        lib.szt_lorenzo_sweep.argtypes = [p, p, p, p, i32, i32, i32, C.c_double, C.c_double,
                                          i32, i32, p, i64, p]
        lib.szt_lorenzo_select.restype = i32
        lib.szt_lorenzo_select.argtypes = [p, p, p, p, p, i32, i32, i32, C.c_float, p]
        lib.szt_interp_encode.restype = i32
        lib.szt_interp_encode.argtypes = [p, p, p, i32, i64, i64, i64, i64, i64, i32, i32,
                                          C.c_double, p, p, i32, p]
        lib.szt_biomd_frames.restype = i32
        lib.szt_biomd_frames.argtypes = [p, p, p, p, i64, i32, i32, i32, C.c_double, C.c_double,
                                         i32, i32, p]
        lib.szt_mdz_frames.restype = i32
        lib.szt_mdz_frames.argtypes = [p, p, i64, p, p, p, i64, i32, C.c_double, C.c_double,
                                       i32, i32, p]
        _lib = lib
    return _lib


# ---- host engine ---------------------------------------------------------------

_ZSTD_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/usr/lib/aarch64-linux-gnu",
                  "/usr/lib64", "/usr/lib", "/lib/x86_64-linux-gnu", "/usr/local/lib")


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _engine_sources():
    return [ENGINE_SRC / "szt_core.cpp"], sorted((ENGINE_SRC / "szt").glob("*.hpp"))


def engine_lib_path() -> Path:
    src, hdr = _engine_sources()
    return BUILD_DIR / f"libszt_host-{_hash(src + hdr, CXXFLAGS)}.so"


def _zstd_runtime_library() -> str:
    dirs = [d for d in os.environ.get("LD_LIBRARY_PATH", "").split(":") if d]
    for d in dirs + list(_ZSTD_LIB_DIRS):
        hits = sorted(glob.glob(os.path.join(d, "libzstd.so.1*")))
        if hits:
            return hits[0]
    raise RuntimeError("the host engine needs zstd: neither zstd.h nor libzstd.so.1 "
                       "was found")


def _has_zstd_header() -> bool:
    probe = subprocess.run([_cxx(), "-E", "-x", "c++", "-", "-o", os.devnull],
                           input="#include <zstd.h>\n", capture_output=True, text=True)
    return probe.returncode == 0


def _zstd_flags() -> List[str]:
    """Extra compiler flags for a machine without zstd's development files."""
    if _has_zstd_header():
        return []
    link_dir = BUILD_DIR / "zstd_link"
    link_dir.mkdir(parents=True, exist_ok=True)
    link = link_dir / "libzstd.so"
    target = _zstd_runtime_library()
    # the engine's and the plugin's builds may run at once: the link is
    # replaced atomically, and only when it points elsewhere
    if not (link.is_symlink() and os.readlink(link) == target):
        tmp = link_dir / f"libzstd.so.{os.getpid()}.{threading.get_ident()}"
        tmp.unlink(missing_ok=True)
        tmp.symlink_to(target)
        os.replace(tmp, link)
    return ["-I", str(CSRC / "zstd"), "-L", str(link_dir)]


def build_engine(verbose: bool = False) -> Path:
    """Compile the host engine unless a build of the current sources exists."""
    out = engine_lib_path()
    if out.exists():
        return out
    with _build_lock("engine"):
        if out.exists():
            return out
        src, _ = _engine_sources()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_cxx(), *CXXFLAGS, "-I", str(ENGINE_SRC), *_zstd_flags(),
               *(str(s) for s in src), "-o", str(tmp), "-lzstd"]
        if verbose:
            print("host engine build:", " ".join(cmd), flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host engine build failed:\n{proc.stderr}")
        os.replace(tmp, out)
        _drop_stale("libszt_host-*.so", out)
    return out


# ---- HDF5 filter plugin -----------------------------------------------------------

H5Z_SRC = CSRC / "h5z_szt.cpp"


def h5z_lib_path() -> Path:
    _, hdr = _engine_sources()
    return BUILD_DIR / f"libh5zszt-{_hash([H5Z_SRC] + hdr, CXXFLAGS)}.so"


def build_h5z(verbose: bool = False) -> Path:
    """Compile the HDF5 filter plugin (filter id 32024, ``csrc/h5z_szt.cpp``
    over the engine's headers) unless a build of the current sources exists.
    The plugin compresses each chunk with the engine inside libhdf5, on the
    host; it links zstd as the engine does."""
    out = h5z_lib_path()
    if out.exists():
        return out
    with _build_lock("h5z"):
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_cxx(), *CXXFLAGS, "-I", str(ENGINE_SRC), *_zstd_flags(), str(H5Z_SRC),
               "-o", str(tmp), "-lzstd", "-ldl"]
        if verbose:
            print("h5z plugin build:", " ".join(cmd), flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"h5z plugin build failed:\n{proc.stderr}")
        os.replace(tmp, out)
        _drop_stale("libh5zszt-*.so", out)
    return out


def host_engine():
    """The port's ctypes binding of the host engine (``runtime.py``), with
    the engine built and loaded."""
    from . import runtime

    runtime.lib()
    return runtime
