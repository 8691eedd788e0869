"""sz3t-torch — command-line interface, argument-compatible with the
reference sz3 CLI (tools/sz3/sz3.cpp:190-498), including SZ2-style -z/-x/-s
forms (counterpart of sz3_tpu/cli.py).

Extra flags beyond the reference:
  --backend torch|native  execution engine (default torch: the port's
                          compress/decompress; native: the host engine alone)
  --device cuda|cpu       where the torch backend and -a run (default cuda,
                          which raises without a card)
  --threads N             chunk count for OpenMP-mode archives
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import runtime
from .api import _device, archive_conf, compress, decompress, open_archive, pack_archive
from .config import EB, EB_MAP, Config, DataType
from .stats import verify

USAGE = """Usage: sz3t-torch <options>
* general: -h help | -v version | -a print distortion stats
* input/output: -i <raw input> -o <decompressed output> -z <compressed file> -t (text output)
* data type: -f float32 | -d float64 | -I 32|64 (int)
* config file: -c <sz3.config INI>
* error control: -M ABS|REL|PSNR|NORM|ABS_AND_REL|ABS_OR_REL [bound]
                 -A <abs> -R <rel> -S <psnr> -N <norm>
* dimensions (fastest first): -1 nx | -2 nx ny | -3 nx ny nz | -4 nx ny nz np
* extras: --backend torch|native  --device cuda|cpu  --threads N
examples:
  sz3t-torch -f -i test.dat -z test.sz -3 8 8 128 -M ABS 1e-3
  sz3t-torch -f -z test.sz -o test.out -3 8 8 128 -a -i test.dat
"""

_NP_DTYPE = {DataType.FLOAT: np.float32, DataType.DOUBLE: np.float64,
             DataType.INT32: np.int32, DataType.INT64: np.int64}
BACKENDS = ("torch", "native")


def _fail(msg: str = "") -> "NoReturn":
    if msg:
        print(msg)
    print(USAGE)
    sys.exit(1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        _fail()
    try:
        return _parse_and_run(argv)
    except IndexError:
        _fail("Error: option is missing its argument")


def _parse_and_run(argv: List[str]) -> int:
    dtype = DataType.FLOAT
    in_path = cmp_path = dec_path = con_path = None
    binary_output, print_stats, print_meta = True, False, False
    do_comp = do_dec = sz2mode = del_cmp = False
    eb_mode = eb_val = None
    abs_eb = rel_eb = psnr_eb = norm_eb = None
    dims_fastest: List[int] = []
    backend, device, nthreads = "torch", "cuda", 0

    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--backend":
            i += 1
            backend = argv[i]
            if backend not in BACKENDS:
                _fail(f"Error: unknown backend {backend!r} (torch or native)")
        elif a == "--device":
            i += 1
            device = argv[i]
        elif a == "--threads":
            i += 1
            nthreads = int(argv[i])
        elif a in ("-h", "-h2"):
            print(USAGE)
            return 0
        elif a == "-v":
            from . import SZ3_DATA_VER, __version__
            print(f"sz3-tpu Version: {__version__}")
            print(f"SZ3 Data Format Version: {'.'.join(map(str, SZ3_DATA_VER))}")
            return 0
        elif a == "-b":
            binary_output = True
        elif a == "-t":
            binary_output = False
        elif a == "-a":
            print_stats = True
        elif a == "-p":
            print_meta = True
        elif a == "-z":
            do_comp = True
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                cmp_path = argv[i]
        elif a == "-x":
            sz2mode = do_dec = True
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                dec_path = argv[i]
        elif a == "-f":
            dtype = DataType.FLOAT
        elif a == "-d":
            dtype = DataType.DOUBLE
        elif a == "-I":
            i += 1
            w = argv[i]
            dtype = {"32": DataType.INT32, "64": DataType.INT64}.get(w) or _fail()
        elif a == "-i":
            i += 1
            in_path = argv[i]
        elif a == "-o":
            i += 1
            dec_path = argv[i]
        elif a == "-s":
            sz2mode = True
            i += 1
            cmp_path = argv[i]
        elif a == "-c":
            i += 1
            con_path = argv[i]
        elif a in ("-1", "-2", "-3", "-4"):
            n = int(a[1])
            dims_fastest = [int(argv[i + k + 1]) for k in range(n)]
            i += n
        elif a == "-M":
            i += 1
            eb_mode = argv[i]
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                eb_val = argv[i]
        elif a == "-A":
            i += 1
            abs_eb = argv[i]
        elif a == "-R":
            i += 1
            rel_eb = argv[i]
        elif a == "-S":
            i += 1
            psnr_eb = argv[i]
        elif a == "-N":
            i += 1
            norm_eb = argv[i]
        else:
            _fail(f"unknown option {a}")
        i += 1

    if in_path is None and cmp_path is None:
        _fail("Error: specify a raw binary input (-i) or a compressed file (-z/-s)")
    if do_comp and cmp_path is None and in_path:
        cmp_path = in_path + ".sz"  # pathless -z, like the reference CLI
    if not sz2mode and in_path and cmp_path:
        do_comp = True
    if cmp_path and dec_path:
        do_dec = True
    if in_path and cmp_path is None and dec_path:
        # implicit compress+decompress through a temp archive needs a bound
        if eb_mode is None and con_path is None:
            _fail("Error: compression needs an error bound (-M ... or -c config)")
        do_comp = do_dec = del_cmp = True
        cmp_path = in_path + ".sz.tmp"
    if in_path is None or (eb_mode is None and con_path is None):
        do_comp = False
        del_cmp = False
    if not do_comp and not do_dec:
        _fail()
    # range-relative modes with a zero bound always destroy the data; the
    # reference proceeds silently, we refuse (-M ABS 0 stays legal: lossless)
    if do_comp and eb_mode is not None:
        mode_up = eb_mode.upper()
        zero_checks = {"REL": rel_eb, "VR_REL": rel_eb, "PSNR": psnr_eb, "NORM": norm_eb}
        if mode_up in zero_checks and not float(eb_val or zero_checks[mode_up] or 0):
            _fail(f"Error: -M {eb_mode} needs a positive bound "
                  f"(inline or via -R/-S/-N)")

    conf = Config(dims=tuple(reversed(dims_fastest)) if dims_fastest else (1,))
    if do_comp and con_path:
        conf.loadcfg(con_path)
    if eb_mode is not None:
        if rel_eb is not None:
            conf.relErrorBound = float(rel_eb)
        if abs_eb is not None:
            conf.absErrorBound = float(abs_eb)
        if psnr_eb is not None:
            conf.psnrErrorBound = float(psnr_eb)
        if norm_eb is not None:
            conf.l2normErrorBound = float(norm_eb)
        mode = eb_mode.upper()
        if mode == "VR_REL":
            mode = "REL"
        if mode not in EB_MAP:
            _fail(f"Error: wrong error bound mode {eb_mode}")
        conf.errorBoundMode = EB_MAP[mode]
        if eb_val is not None:
            field = {EB.ABS: "absErrorBound", EB.REL: "relErrorBound",
                     EB.PSNR: "psnrErrorBound", EB.L2NORM: "l2normErrorBound"}.get(
                         conf.errorBoundMode)
            if field:
                setattr(conf, field, float(eb_val))

    dev = _device(device)
    np_dt = _NP_DTYPE[dtype]

    if do_comp:
        data = np.fromfile(in_path, dtype=np_dt)
        if conf.num not in (0, data.size):
            _fail(f"Error: file has {data.size} elements, dims say {conf.num}")
        data = data.reshape(conf.dims)
        t0 = time.time()
        # CLI parity: leave conf.dataType untouched (reference never sets it)
        if backend == "torch":
            blob = compress(data, conf, device=dev, nthreads=nthreads, set_datatype=False)
        else:
            c, cap = archive_conf(data, conf, set_datatype=False)
            blob = pack_archive(c, runtime.compress_payload(c, data, cap, nthreads))
        dt_s = time.time() - t0
        with open(cmp_path, "wb") as f:
            f.write(blob)
        print(f"compression ratio = {data.nbytes / len(blob):.2f} ")
        print(f"compression time = {dt_s:f}")
        print(f"compressed data file = {cmp_path}")

    if do_dec:
        if print_stats and in_path is None:
            print("Error: -a requires the original data path via -i <path>.")
            return 1
        with open(cmp_path, "rb") as f:
            blob = f.read()
        t0 = time.time()
        if backend == "torch":
            out, dconf = decompress(blob, device=dev, dtype=np_dt)
            _sync(dev)
        else:
            dconf, payload = open_archive(blob)
            out = torch.from_numpy(runtime.decompress_payload(
                dconf, payload, dtype=runtime.np_dtype_id(np.empty(0, np_dt))))
        dt_s = time.time() - t0
        host = out.cpu().numpy()       # the one copy of the output to the host
        out_path = dec_path or (cmp_path + ".out")
        if binary_output:
            host.tofile(out_path)
        else:
            np.savetxt(out_path, host.ravel())
        if print_stats:
            ori = torch.from_numpy(np.fromfile(in_path, dtype=np_dt)).to(dev)
            print(verify(ori, out.to(dev)).report())
        print(f"compression ratio = {host.nbytes / len(blob):f}")
        print(f"decompression time = {dt_s:f} seconds.")
        print(f"decompressed file = {out_path}")
        if print_meta:
            print(dconf.save_ini())

    if del_cmp:
        os.remove(cmp_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
