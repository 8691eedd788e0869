"""The port's build helpers: the host engine's build (its flags, its zstd
prerequisites on a machine without zstd's header, one build for processes
that start together), and the kernel build's refusal to go on without nvcc."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sz3_tpu.native import build as native_build
from sz3_tpu_torch import build, runtime

ROOT = Path(__file__).resolve().parents[1]


def _fake_compiler(monkeypatch, tmp_path, returncode=0, stderr=""):
    """Point the engine build at an empty build directory and record the
    compiler command instead of running it."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        if returncode == 0:
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, returncode, "", stderr)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    return cmds


def test_host_engine_retries_with_zstd_declarations(monkeypatch, tmp_path):
    """Without zstd.h the engine is built against csrc/zstd/zstd.h and a
    libzstd.so link to the installed runtime library, both named on the
    command line; the process environment is not touched."""
    cmds = _fake_compiler(monkeypatch, tmp_path)
    monkeypatch.setattr(build, "_has_zstd_header", lambda: False)
    monkeypatch.delenv("CPLUS_INCLUDE_PATH", raising=False)
    monkeypatch.setenv("LIBRARY_PATH", "/usr/local/elsewhere")
    env = dict(os.environ)
    out = build.build_engine()
    assert out == build.engine_lib_path() and out.parent == tmp_path and out.exists()
    (cmd,) = cmds
    assert cmd[cmd.index("-I", cmd.index("-I") + 1) + 1] == str(build.CSRC / "zstd")
    assert cmd[cmd.index("-L") + 1] == str(tmp_path / "zstd_link")
    assert (tmp_path / "zstd_link" / "libzstd.so").resolve().name.startswith("libzstd.so.1")
    assert dict(os.environ) == env
    # a second call finds the build and compiles nothing
    assert build.build_engine() == out and len(cmds) == 1


def test_host_engine_reraises_other_build_errors(monkeypatch, tmp_path):
    _fake_compiler(monkeypatch, tmp_path, returncode=1, stderr="something else")
    monkeypatch.setattr(build, "_has_zstd_header", lambda: True)
    with pytest.raises(RuntimeError, match="something else"):
        build.build_engine()
    assert not list(tmp_path.glob("libszt_host-*"))


def test_engine_build_flags_and_location(monkeypatch, tmp_path):
    """The flags of sz3_tpu/native/build.py (-ffp-contract=off keeps archives
    bit-equal), the port's own sources, and no zstd extras where zstd.h is
    installed."""
    assert build.host_engine() is runtime
    assert Path(runtime.lib()._name).parent == build.BUILD_DIR
    cmds = _fake_compiler(monkeypatch, tmp_path)
    monkeypatch.setattr(build, "_has_zstd_header", lambda: True)
    build.build_engine()
    (cmd,) = cmds
    assert build.CXXFLAGS == native_build.CXXFLAGS and "-ffp-contract=off" in cmd
    assert str(build.ENGINE_SRC / "szt_core.cpp") in cmd and "-L" not in cmd
    assert cmd[-1] == "-lzstd"


_RACE = r"""
import sys, time
from pathlib import Path
from sz3_tpu_torch import build
build.BUILD_DIR = Path(sys.argv[1])
real = build.subprocess.run
def slow(cmd, **kw):
    if "-shared" not in cmd:
        return real(cmd, **kw)
    with open(Path(sys.argv[1]) / "compiles.log", "a") as f:
        f.write("x")
    time.sleep(1.0)
    Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
    return build.subprocess.CompletedProcess(cmd, 0, "", "")
build.subprocess.run = slow
print(build.build_engine())
"""


def test_engine_builds_once_for_processes_that_start_together(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o[0] for o in outs}) == 1
    assert (tmp_path / "compiles.log").read_text() == "x"


_PROGRAM = r"""
#include <zstd.h>
#include <cstdio>
#include <vector>
int main() {
    std::vector<unsigned char> src(20000);
    for (size_t i = 0; i < src.size(); ++i) src[i] = (unsigned char)((i * 7) % 251);
    std::vector<unsigned char> dst(ZSTD_compressBound(src.size()));
    size_t n = ZSTD_compress(dst.data(), dst.size(), src.data(), src.size(), 3);
    if (ZSTD_isError(n)) { std::puts(ZSTD_getErrorName(n)); return 1; }
    if (ZSTD_getFrameContentSize(dst.data(), n) != src.size()) return 2;
    std::vector<unsigned char> back(src.size());
    size_t m = ZSTD_decompress(back.data(), back.size(), dst.data(), n);
    if (ZSTD_isError(m) || back != src) return 3;
    // the first 100 bytes through the streaming decoder, which stops there
    ZSTD_DCtx* d = ZSTD_createDCtx();
    std::vector<unsigned char> head(100);
    ZSTD_inBuffer in = {dst.data(), n, 0};
    ZSTD_outBuffer out = {head.data(), head.size(), 0};
    while (out.pos < out.size && in.pos < in.size) {
        size_t r = ZSTD_decompressStream(d, &out, &in);
        if (ZSTD_isError(r) || r == 0) break;
    }
    ZSTD_freeDCtx(d);
    if (out.pos != head.size()) return 4;
    for (size_t i = 0; i < head.size(); ++i) if (head[i] != src[i]) return 5;
    for (size_t i = 0; i < n; ++i) std::printf("%02x", dst[i]);
    return 0;
}
"""


def test_zstd_declarations_match_the_installed_library(tmp_path):
    """A program built against csrc/zstd/zstd.h and linked through the same
    libzstd.so link the engine build makes writes the engine's zstd bytes."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "z.cpp"
    src.write_text(_PROGRAM)
    (tmp_path / "libzstd.so").symlink_to(build._zstd_runtime_library())
    exe = tmp_path / "z"
    subprocess.run(["g++", "-std=c++17", "-I", str(build.CSRC / "zstd"), str(src), "-o", str(exe),
                    "-L", str(tmp_path), "-lzstd"], check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True, timeout=60)
    raw = bytes((i * 7) % 251 for i in range(20000))
    assert bytes.fromhex(out.stdout) == runtime.zstd_compress(raw)[8:]


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build, "kernel_lib_path", lambda: build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_kernels()
