"""H5Z-SZ3 helper tools (reference tools/H5Z-SZ3/test/*.cpp; counterpart of
sz3_tpu/h5tools.py), over the port's filter (sz3_tpu_torch.h5):

  sz3ToHDF5 <dtype> <infile> <r1> [r2 ...]   raw binary -> <infile>.sz3.h5
                                             compressed with filter 32024
  dsz3FromHDF5 <file.h5>                     compressed HDF5 -> <file>.h5.out
                                             (raw binary of the dataset)
  convertBinToHDF5 <dtype> <var> <in> <r1..> raw binary -> plain <in>.h5

dtype names follow the reference tools: FLOAT/DOUBLE/INT8..INT64/UINT8..
UINT64. The error bound comes from an sz3.config INI in the working
directory when present (like the reference filter's defaults) or -M/-A
style flags appended after the positional arguments.

Usage: python -m sz3_tpu_torch.h5tools <tool> <args...>   (also exposed as
the `sz3t-torch-h5` console entry).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

_DTYPES = {
    "FLOAT": np.float32, "DOUBLE": np.float64,
    "INT8": np.int8, "UINT8": np.uint8,
    "INT16": np.int16, "UINT16": np.uint16,
    "INT32": np.int32, "UINT32": np.uint32,
    "INT64": np.int64, "UINT64": np.uint64,
}

DATASET = "testdata_compressed"


def _parse_tail(args):
    """Positional dims then optional -c ini / -M MODE EB overrides."""
    from .config import Config

    dims = []
    i = 0
    conf_kw = {}
    ini = None
    while i < len(args):
        a = args[i]
        if a == "-c":
            ini = args[i + 1]
            i += 2
        elif a == "-M":
            conf_kw["mode"] = args[i + 1]
            conf_kw["eb"] = float(args[i + 2])
            i += 3
        else:
            dims.append(int(a))
            i += 1
    return dims, ini, conf_kw


def sz3_to_hdf5(argv):
    import h5py

    from . import h5 as h5f
    from .config import EB, Config

    if len(argv) < 3:
        print("Usage: sz3ToHDF5 [dataType] [srcFilePath] [dimension sizes...]",
              file=sys.stderr)
        return 1
    dtype = _DTYPES[argv[0].upper()]
    src = argv[1]
    dims, ini, kw = _parse_tail(argv[2:])
    # reference order: fastest dim first on the CLI; HDF5 wants slowest first
    shape = tuple(reversed(dims))
    data = np.fromfile(src, dtype=dtype).reshape(shape)
    conf = Config(dims=shape)
    if ini:
        conf.loadcfg(ini)
    elif Path("sz3.config").exists():
        conf.loadcfg("sz3.config")
    if kw:
        mode = kw["mode"]
        conf.errorBoundMode = EB[mode if mode != "NORM" else "L2NORM"]
        if mode == "ABS":
            conf.absErrorBound = kw["eb"]
        elif mode == "REL":
            conf.relErrorBound = kw["eb"]
    out = f"{src}.sz3.h5"
    h5f.register()
    with h5py.File(out, "w") as f:
        f.create_dataset(DATASET, data=data, chunks=shape,
                         compression=h5f.FILTER_ID,
                         compression_opts=h5f.cd_values(conf))
    print(f"Output hdf5 file: {out}")
    return 0


def dsz3_from_hdf5(argv):
    import h5py

    from . import h5 as h5f

    if len(argv) < 1:
        print("Usage: dsz3FromHDF5 [hdf5FilePath]", file=sys.stderr)
        return 1
    src = argv[0]
    h5f.register()
    with h5py.File(src, "r") as f:
        name = DATASET if DATASET in f else list(f.keys())[0]
        data = np.asarray(f[name])
    out = f"{src}.out"
    data.tofile(out)
    print(f"Decompressed binary: {out} ({data.shape} {data.dtype})")
    return 0


def convert_bin_to_hdf5(argv):
    import h5py

    if len(argv) < 4:
        print("Usage: convertBinToHDF5 [datatype] [varName] [infile] "
              "[r1, r2, r3, ....]", file=sys.stderr)
        return 1
    dtype = _DTYPES[argv[0].upper()]
    var = argv[1]
    src = argv[2]
    dims = [int(a) for a in argv[3:]]
    shape = tuple(reversed(dims))
    data = np.fromfile(src, dtype=dtype).reshape(shape)
    out = f"{src}.h5"
    with h5py.File(out, "w") as f:
        f.create_dataset(var, data=data)
    print(f"Output hdf5 file: {out}")
    return 0


TOOLS = {
    "sz3ToHDF5": sz3_to_hdf5,
    "dsz3FromHDF5": dsz3_from_hdf5,
    "convertBinToHDF5": convert_bin_to_hdf5,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        print(f"Usage: sz3t-torch-h5 {{{'|'.join(TOOLS)}}} <args...>",
              file=sys.stderr)
        return 1
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
