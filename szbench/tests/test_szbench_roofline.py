"""The roofline byte counts on known shapes."""

import pytest

from szbench.roofline import peaks, stages


def test_entropy_encode_bytes():
    n = 256 ** 3
    bits = 92_274_688                      # 5.5 bits a symbol
    assert stages.entropy_encode_bytes(n, bits) == 4 * n + bits // 8
    assert stages.entropy_encode_bytes(1, 1) == 5          # a partial byte counts whole


def test_huffman_decode_bytes():
    assert stages.huffman_decode_bytes(11_534_336, 256 ** 3) == 11_534_336 + 4 * 256 ** 3


def test_lorenzo_sweep_bytes():
    cells = 516 * 516 * 516                # 512^3 rounded up to blocks of 6
    assert stages.lorenzo_sweep_bytes(cells) == 12 * cells


def test_share():
    nbytes = int(peaks.HBM_BYTES_PER_S * 1e-3)   # one ms at the peak
    assert stages.share_pct(nbytes, 2e-3) == pytest.approx(50.0)
    assert stages.bound_s(0, int(peaks.OPS_PER_S)) == 1.0
    assert stages.share_pct(nbytes, 0.0) is None and stages.share_pct(0, 1.0) is None
