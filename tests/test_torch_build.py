"""The port's build helpers: the host engine's zstd prerequisites on a
machine without zstd's header, and the kernel build's refusal to go on
without nvcc."""

import os
import shutil
import subprocess

import pytest

from sz3_tpu import runtime
from sz3_tpu_torch import build


def test_host_engine_retries_with_zstd_declarations(monkeypatch):
    calls = []

    def fake_lib():
        calls.append({v: os.environ.get(v) for v in ("CPLUS_INCLUDE_PATH", "LIBRARY_PATH")})
        if len(calls) == 1:
            raise RuntimeError("native build failed:\nzstd_wrap.hpp:9:10: fatal error: "
                               "zstd.h: No such file or directory")

    monkeypatch.setattr(runtime, "lib", fake_lib)
    monkeypatch.delenv("CPLUS_INCLUDE_PATH", raising=False)
    monkeypatch.setenv("LIBRARY_PATH", "/usr/local/elsewhere")
    assert build.host_engine() is runtime
    assert len(calls) == 2
    assert calls[1]["CPLUS_INCLUDE_PATH"] == str(build.CSRC / "zstd")
    link_dir = str(build.BUILD_DIR / "zstd_link")
    assert calls[1]["LIBRARY_PATH"] == f"{link_dir}{os.pathsep}/usr/local/elsewhere"
    assert (build.BUILD_DIR / "zstd_link" / "libzstd.so").resolve().name.startswith("libzstd.so.1")
    # the environment is restored
    assert "CPLUS_INCLUDE_PATH" not in os.environ
    assert os.environ["LIBRARY_PATH"] == "/usr/local/elsewhere"


def test_host_engine_reraises_other_build_errors(monkeypatch):
    def fake_lib():
        raise RuntimeError("native build failed: something else")

    monkeypatch.setattr(runtime, "lib", fake_lib)
    with pytest.raises(RuntimeError, match="something else"):
        build.host_engine()


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
    for (size_t i = 0; i < n; ++i) std::printf("%02x", dst[i]);
    return 0;
}
"""


def test_zstd_declarations_match_the_installed_library(tmp_path):
    """A program built against csrc/zstd/zstd.h and linked through the same
    libzstd.so link the fallback makes writes the engine's zstd bytes."""
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
