"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full 700 W). A card set below 700 W runs slower: the harness
prints the card's power limit beside every traced run."""

HBM_BYTES_PER_S = 3.35e12     # HBM3, 80 GB
# the stages are 32-bit integer and float32 work outside the tensor cores;
# the float32 rate outside the tensor cores stands in as their peak
OPS_PER_S = 67e12
