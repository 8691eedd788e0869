"""Compression configuration: knobs, INI parsing, and the compact binary form
embedded in every archive.

Byte-level contract follows the reference Config (utils/Config.hpp:312-413):
little-endian, 1-byte total-size prefix, bit-packed dims, error-bound fields
conditional on the mode, forward-compatible optional tail.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field, replace
from typing import List, Sequence, Tuple

SZ3_MAGIC_NUMBER = 0xF342F310  # reference version.hpp.in:10


def version_int(ver: Tuple[int, int, int]) -> int:
    """(major, minor, patch) -> packed uint32 (reference version.hpp.in:21-27)."""
    major, minor, patch = ver
    return ((major << 24) | (minor << 16) | (patch << 8)) & 0xFFFFFFFF


def version_str(v: int) -> str:
    return f"{(v >> 24) & 0xFF}.{(v >> 16) & 0xFF}.{(v >> 8) & 0xFF}"


class EB(enum.IntEnum):
    """Error bound modes (reference utils/Config.hpp:54)."""
    ABS = 0
    REL = 1
    PSNR = 2
    L2NORM = 3
    ABS_AND_REL = 4
    ABS_OR_REL = 5


class ALGO(enum.IntEnum):
    """Compression algorithms (reference utils/Config.hpp:68)."""
    LORENZO_REG = 0
    INTERP_LORENZO = 1
    INTERP = 2
    NOPRED = 3
    LOSSLESS = 4
    BIOMD = 5
    BIOMDXTC = 6


class INTERP_ALGO(enum.IntEnum):
    """Interpolation basis (reference utils/Config.hpp:77)."""
    LINEAR = 0
    CUBIC = 1


class DataType(enum.IntEnum):
    """On-archive dtype ids (reference utils/Config.hpp:27-36)."""
    FLOAT = 0
    DOUBLE = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    UINT32 = 6
    INT32 = 7
    UINT64 = 8
    INT64 = 9


# Names accepted in INI / CLI (reference utils/Config.hpp:79-98).
ALGO_MAP = {
    "ALGO_LORENZO_REG": ALGO.LORENZO_REG,
    "ALGO_INTERP_LORENZO": ALGO.INTERP_LORENZO,
    "ALGO_INTERP": ALGO.INTERP,
    "ALGO_NOPRED": ALGO.NOPRED,
    "ALGO_LOSSLESS": ALGO.LOSSLESS,
    "ALGO_BIOMD": ALGO.BIOMD,
    "ALGO_BIOMDXTC": ALGO.BIOMDXTC,
}
EB_MAP = {
    "ABS": EB.ABS,
    "REL": EB.REL,
    "PSNR": EB.PSNR,
    "NORM": EB.L2NORM,
    "ABS_AND_REL": EB.ABS_AND_REL,
    "ABS_OR_REL": EB.ABS_OR_REL,
}
INTERP_ALGO_MAP = {
    "INTERP_ALGO_LINEAR": INTERP_ALGO.LINEAR,
    "INTERP_ALGO_CUBIC": INTERP_ALGO.CUBIC,
}


def _match_enum(value: str, table: dict):
    lv = value.lower()
    for k, v in table.items():
        if k.lower() == lv:
            return v
    return None


def vector_bit_width(values: Sequence[int]) -> int:
    """Bits needed for the largest element (reference utils/ByteUtil.hpp:194-204)."""
    if not values:
        return 0
    m = max(values)
    bits = 0
    while m > 0:
        m >>= 1
        bits += 1
    return bits


def pack_bits(values: Sequence[int], bit_width: int) -> bytes:
    """LSB-first bit packing of fixed-width ints (reference ByteUtil.hpp:206-238)."""
    out = bytearray()
    cur = 0
    nbits = 0
    for v in values:
        cur |= (v & ((1 << bit_width) - 1)) << nbits
        nbits += bit_width
        while nbits >= 8:
            out.append(cur & 0xFF)
            cur >>= 8
            nbits -= 8
    if nbits:
        out.append(cur & 0xFF)
    return bytes(out)


def unpack_bits(data: bytes, bit_width: int, count: int) -> List[int]:
    """Inverse of pack_bits (reference ByteUtil.hpp:240-264)."""
    total = int.from_bytes(data[: (count * bit_width + 7) // 8], "little")
    mask = (1 << bit_width) - 1
    return [(total >> (i * bit_width)) & mask for i in range(count)]


@dataclass
class Config:
    """All compression knobs.

    Defaults mirror the reference (utils/Config.hpp:441-478). ``dims`` is
    slowest-dimension-first, like a numpy shape.
    """

    dims: Tuple[int, ...] = (1,)
    cmprAlgo: ALGO = ALGO.INTERP_LORENZO
    errorBoundMode: EB = EB.ABS
    absErrorBound: float = 1e-3
    relErrorBound: float = 0.0
    psnrErrorBound: float = 0.0
    l2normErrorBound: float = 0.0
    openmp: bool = False

    quantbinCnt: int = 65536
    blockSize: int = 0
    predDim: int = 0
    dataType: DataType = DataType.FLOAT
    lorenzo: bool = True
    lorenzo2: bool = False
    regression: bool = True
    regression2: bool = False
    interpAlgo: INTERP_ALGO = INTERP_ALGO.CUBIC
    interpDirection: int = 0
    interpAnchorStride: int = -1
    interpAlpha: float = 1.25
    interpBeta: float = 2.0

    sz3MagicNumber: int = SZ3_MAGIC_NUMBER
    sz3DataVer: int = field(default_factory=lambda: version_int((3, 3, 2)))

    def __post_init__(self):
        self.set_dims(self.dims)

    # -- dimensions ---------------------------------------------------------

    def set_dims(self, dims: Sequence[int]) -> int:
        """Drop size-1 dims, derive N/num/blockSize (reference Config.hpp:160-177)."""
        d = tuple(int(x) for x in dims if int(x) > 1)
        if not d:
            d = (1,)
        self.dims = d
        num = 1
        for x in d:
            num *= x
        self.predDim = self.N
        self.blockSize = 128 if self.N == 1 else (16 if self.N == 2 else 6)
        return num

    @property
    def N(self) -> int:
        return len(self.dims)

    @property
    def num(self) -> int:
        n = 1
        for x in self.dims:
            n *= x
        return n

    def copy(self) -> "Config":
        return replace(self)

    # -- binary serialization (archive tail / cd_values) ---------------------

    def save(self) -> bytes:
        """Compact binary form (reference Config.hpp:312-354)."""
        body = bytearray()
        body += struct.pack("<b", self.N)
        bw = vector_bit_width(self.dims)
        body += struct.pack("<B", bw)
        body += pack_bits(self.dims, bw)
        body += struct.pack("<Q", self.num)
        body += struct.pack("<B", int(self.cmprAlgo))
        body += struct.pack("<B", int(self.errorBoundMode))
        if self.errorBoundMode == EB.ABS:
            body += struct.pack("<d", self.absErrorBound)
        elif self.errorBoundMode == EB.REL:
            body += struct.pack("<d", self.relErrorBound)
        elif self.errorBoundMode == EB.PSNR:
            body += struct.pack("<d", self.psnrErrorBound)
        elif self.errorBoundMode == EB.L2NORM:
            body += struct.pack("<d", self.l2normErrorBound)
        elif self.errorBoundMode in (EB.ABS_OR_REL, EB.ABS_AND_REL):
            body += struct.pack("<d", self.absErrorBound)
            body += struct.pack("<d", self.relErrorBound)
        boolvals = ((self.lorenzo & 1) << 7 | (self.lorenzo2 & 1) << 6 |
                    (self.regression & 1) << 5 | (self.regression2 & 1) << 4 |
                    (self.openmp & 1) << 3)
        body += struct.pack("<B", boolvals)
        body += struct.pack("<B", int(self.dataType))
        body += struct.pack("<i", self.quantbinCnt)
        body += struct.pack("<i", self.blockSize)
        body += struct.pack("<B", self.predDim)
        conf_size = len(body) + 1
        if conf_size > 255:
            raise ValueError("config serialization exceeds 1-byte size prefix")
        return bytes([conf_size]) + bytes(body)

    @classmethod
    def load(cls, data: bytes, offset: int = 0) -> Tuple["Config", int]:
        """Parse binary form; returns (config, bytes consumed).

        Mirrors reference Config.hpp:361-413 incl. forward-compatible tail.
        """
        conf_size = data[offset]
        end = offset + conf_size
        pos = offset + 1
        n = struct.unpack_from("<b", data, pos)[0]; pos += 1
        bw = data[pos]; pos += 1
        nbytes = (n * bw + 7) // 8
        dims = unpack_bits(data[pos:pos + nbytes], bw, n); pos += nbytes
        num = struct.unpack_from("<Q", data, pos)[0]; pos += 8
        algo = ALGO(data[pos]); pos += 1
        ebm = EB(data[pos]); pos += 1
        c = cls.__new__(cls)  # bypass __post_init__ (dims already final)
        c.dims = tuple(dims)
        c.cmprAlgo = algo
        c.errorBoundMode = ebm
        c.absErrorBound, c.relErrorBound = 1e-3, 0.0
        c.psnrErrorBound, c.l2normErrorBound = 0.0, 0.0
        c.openmp = False
        c.quantbinCnt, c.blockSize, c.predDim = 65536, 0, 0
        c.dataType = DataType.FLOAT
        c.lorenzo, c.lorenzo2, c.regression, c.regression2 = True, False, True, False
        c.interpAlgo, c.interpDirection = INTERP_ALGO.CUBIC, 0
        c.interpAnchorStride, c.interpAlpha, c.interpBeta = -1, 1.25, 2.0
        c.sz3MagicNumber = SZ3_MAGIC_NUMBER
        c.sz3DataVer = version_int((3, 3, 2))
        if ebm == EB.ABS:
            c.absErrorBound = struct.unpack_from("<d", data, pos)[0]; pos += 8
        elif ebm == EB.REL:
            c.relErrorBound = struct.unpack_from("<d", data, pos)[0]; pos += 8
        elif ebm == EB.PSNR:
            c.psnrErrorBound = struct.unpack_from("<d", data, pos)[0]; pos += 8
        elif ebm == EB.L2NORM:
            c.l2normErrorBound = struct.unpack_from("<d", data, pos)[0]; pos += 8
        elif ebm in (EB.ABS_OR_REL, EB.ABS_AND_REL):
            c.absErrorBound = struct.unpack_from("<d", data, pos)[0]; pos += 8
            c.relErrorBound = struct.unpack_from("<d", data, pos)[0]; pos += 8
        if pos < end:
            b = data[pos]; pos += 1
            c.lorenzo = bool((b >> 7) & 1)
            c.lorenzo2 = bool((b >> 6) & 1)
            c.regression = bool((b >> 5) & 1)
            c.regression2 = bool((b >> 4) & 1)
            c.openmp = bool((b >> 3) & 1)
        if pos < end:
            c.dataType = DataType(data[pos]); pos += 1
        if pos < end:
            c.quantbinCnt = struct.unpack_from("<i", data, pos)[0]; pos += 4
        if pos < end:
            c.blockSize = struct.unpack_from("<i", data, pos)[0]; pos += 4
        if pos < end:
            c.predDim = data[pos]; pos += 1
        if num != c.num:
            raise ValueError(f"config num mismatch: {num} != {c.num}")
        return c, conf_size

    def size_est(self) -> int:
        return len(self.save())

    # -- INI ------------------------------------------------------------------

    def load_ini(self, text: str) -> None:
        """Parse INI content (reference Config.hpp:200-272)."""
        section = ""
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                section = line[1:line.find("]")]
                continue
            if "=" not in line:
                continue
            key, value = (s.strip() for s in line.split("=", 1))
            k, sec = key.lower(), section.lower()
            truthy = value.lower() in ("true", "1", "yes", "on")
            if sec == "globalsettings":
                if k == "cmpralgo":
                    v = _match_enum(value, ALGO_MAP)
                    if v is not None:
                        self.cmprAlgo = v
                elif k == "errorboundmode":
                    v = _match_enum(value, EB_MAP)
                    if v is not None:
                        self.errorBoundMode = v
                elif k == "abserrorbound":
                    self.absErrorBound = float(value)
                elif k == "relerrorbound":
                    self.relErrorBound = float(value)
                elif k == "psnrerrorbound":
                    self.psnrErrorBound = float(value)
                elif k == "l2normerrorbound":
                    self.l2normErrorBound = float(value)
                elif k == "openmp":
                    self.openmp = truthy
            elif sec == "algosettings":
                if k == "lorenzo":
                    self.lorenzo = truthy
                elif k == "lorenzo2ndorder":
                    self.lorenzo2 = truthy
                elif k == "regression":
                    self.regression = truthy
                elif k == "regression2ndorder":
                    self.regression2 = truthy
                elif k == "interpolationalgo":
                    v = _match_enum(value, INTERP_ALGO_MAP)
                    if v is not None:
                        self.interpAlgo = v
                elif k == "interpolationdirection":
                    self.interpDirection = int(value)
                elif k == "blocksize":
                    self.blockSize = int(value)
                elif k == "quantizationbintotal":
                    self.quantbinCnt = int(value)
                elif k == "interpolationanchorstride":
                    self.interpAnchorStride = int(value)
                elif k == "interpolationalpha":
                    self.interpAlpha = float(value)
                elif k == "interpolationbeta":
                    self.interpBeta = float(value)

    def loadcfg(self, path: str) -> None:
        with open(path, "r") as f:
            self.load_ini(f.read())

    def save_ini(self) -> str:
        def b(x):
            return "true" if x else "false"
        algo = next(k for k, v in ALGO_MAP.items() if v == self.cmprAlgo)
        ebm = next(k for k, v in EB_MAP.items() if v == self.errorBoundMode)
        ia = next(k for k, v in INTERP_ALGO_MAP.items() if v == self.interpAlgo)
        return (
            "[GlobalSettings]\n"
            f"CmprAlgo = {algo}\n"
            f"ErrorBoundMode = {ebm}\n"
            f"AbsErrorBound = {self.absErrorBound:g}\n"
            f"RelErrorBound = {self.relErrorBound:g}\n"
            f"PSNRErrorBound = {self.psnrErrorBound:g}\n"
            f"L2NormErrorBound = {self.l2normErrorBound:g}\n"
            f"OpenMP = {b(self.openmp)}\n"
            "\n[AlgoSettings]\n"
            f"Lorenzo = {b(self.lorenzo)}\n"
            f"Lorenzo2ndOrder = {b(self.lorenzo2)}\n"
            f"Regression = {b(self.regression)}\n"
            f"Regression2ndOrder = {b(self.regression2)}\n"
            f"BlockSize = {self.blockSize}\n"
            f"QuantizationBinTotal = {self.quantbinCnt}\n"
            f"InterpolationAlgo = {ia}\n"
            f"InterpolationDirection = {self.interpDirection}\n"
            f"InterpolationAnchorStride = {self.interpAnchorStride}\n"
            f"InterpolationAlpha = {self.interpAlpha:g}\n"
            f"InterpolationBeta = {self.interpBeta:g}\n"
        )
