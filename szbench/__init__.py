"""The benchmark of sz3_tpu_torch on one NVIDIA H100 (szbench/README.md)."""
