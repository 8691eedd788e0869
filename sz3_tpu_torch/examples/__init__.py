"""Examples of extending the port, each run with
``python -m sz3_tpu_torch.examples.<name>``: customized_demo (the reference's
four extension patterns, the counterpart of examples/customized_demo.py)."""
