"""The plain reference: numpy and torch only. It imports nothing of jax, of
the sz3_tpu package or of sz3_tpu_torch, and takes nothing the program made."""
