"""ParaView Python plugin: read SZ3-compressed files into vtkImageData,
decompressing on the CUDA card (counterpart of tools/paraview_sz3_reader.py).

Equivalent of the reference C++ plugin (tools/paraview/SZ3Reader/Reader/
vtkSZ3Reader.{h,cxx}): given a .sz/.sz3 archive and the domain dimensions,
decompresses into a point-data scalar array named "scalar" on a regular grid.
Unlike the C++ reader, the dimensions default to the archive's own Config
tail (SZ3 archives are self-describing), so typing them is optional. The
Device property ("cuda" by default, which needs a card; "cpu" runs the
kernels' plain versions) says where the archive is decoded; the decoded
field is handed to VTK as a numpy array on the host.

Install: ParaView > Tools > Manage Plugins > Load New > this file
(requires PyTorch and `pip install sz3-tpu` or PYTHONPATH pointing at this
repo in the ParaView Python environment).
"""

try:
    from paraview.util.vtkAlgorithm import (VTKPythonAlgorithmBase, smdomain, smhint,
                                            smproperty, smproxy)
    from vtkmodules.numpy_interface import dataset_adapter as dsa
    from vtkmodules.vtkCommonDataModel import vtkImageData
    _HAVE_PARAVIEW = True
except ImportError:  # importable outside ParaView for linting/tests
    _HAVE_PARAVIEW = False

    class VTKPythonAlgorithmBase:  # type: ignore
        def __init__(self, **kw):
            pass

        def Modified(self):
            pass

    def _noop(*a, **k):
        def wrap(x):
            return x
        return wrap

    smproxy = type("smproxy", (), {"reader": staticmethod(_noop)})
    smproperty = type("smproperty", (), {"stringvector": staticmethod(_noop),
                                         "intvector": staticmethod(_noop)})
    smdomain = type("smdomain", (), {"filelist": staticmethod(_noop)})
    smhint = type("smhint", (), {"filechooser": staticmethod(_noop)})

import numpy as np


@smproxy.reader(name="SZ3TpuReader", label="SZ3 Compressed Data Reader",
                extensions="sz sz3 szt", file_description="SZ3 compressed arrays")
class SZ3TpuReader(VTKPythonAlgorithmBase):
    """vtkImageData producer from an SZ3 archive (reference vtkSZ3Reader)."""

    def __init__(self):
        super().__init__(nInputPorts=0, nOutputPorts=1, outputType="vtkImageData")
        self._filename = None
        self._dims = [0, 0, 0]           # optional override, x y z (fastest first)
        self._use_double = 0
        self._device = "cuda"

    @smproperty.stringvector(name="FileName")
    @smdomain.filelist()
    @smhint.filechooser(extensions="sz sz3 szt", file_description="SZ3 archives")
    def SetFileName(self, name):
        if self._filename != name:
            self._filename = name
            self.Modified()

    @smproperty.intvector(name="DomainDimensions", default_values=[0, 0, 0])
    def SetDomainDimensions(self, x, y, z):
        self._dims = [int(x), int(y), int(z)]
        self.Modified()

    @smproperty.intvector(name="UseDoublePrecision", default_values=[0])
    def SetUseDoublePrecision(self, v):
        self._use_double = int(v)
        self.Modified()

    @smproperty.stringvector(name="Device", default_values="cuda")
    def SetDevice(self, device):
        if self._device != device:
            self._device = device
            self.Modified()

    # --- pipeline ---------------------------------------------------------

    def _read(self):
        import sz3_tpu_torch as szp

        with open(self._filename, "rb") as f:
            blob = f.read()
        dtype = np.float64 if self._use_double else np.float32
        out, conf = szp.decompress(blob, device=self._device, dtype=dtype)
        arr = out.cpu().numpy()
        dims = [d for d in self._dims if d > 0]
        if len(dims) == 3:
            # reader dims are x,y,z fastest-first; numpy shape is slowest-first
            arr = arr.reshape(tuple(reversed(dims)))
        return arr

    def RequestInformation(self, request, inInfo, outInfo):
        from vtkmodules.vtkCommonExecutionModel import vtkStreamingDemandDrivenPipeline

        arr = self._read()
        shape = list(reversed(arr.shape)) + [1] * (3 - arr.ndim)
        ext = [0, shape[0] - 1, 0, shape[1] - 1, 0, shape[2] - 1]
        info = outInfo.GetInformationObject(0)
        info.Set(vtkStreamingDemandDrivenPipeline.WHOLE_EXTENT(), *ext)
        return 1

    def RequestData(self, request, inInfo, outInfo):
        arr = self._read()
        shape = list(reversed(arr.shape)) + [1] * (3 - arr.ndim)
        output = dsa.WrapDataObject(vtkImageData.GetData(outInfo))
        output.SetDimensions(*shape)
        output.SetOrigin(0.0, 0.0, 0.0)
        output.SetSpacing(1.0, 1.0, 1.0)
        output.PointData.append(arr.ravel(order="C"), "scalar")
        output.PointData.SetActiveScalars("scalar")
        return 1
