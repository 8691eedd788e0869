"""The port's counterparts of the repository's tools/ scripts, each run with
``python -m sz3_tpu_torch.tools.<name>``: profile_entropy (per-stage times of
the device entropy encode), scaling_bench (rank scaling and the per-chunk
model) and paraview_reader (a ParaView reader plugin)."""
