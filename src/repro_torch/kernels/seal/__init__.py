"""Fused archival seal datapath: pack + ChaCha20 + XOR + RAID parity in one
pass (kernels B5 seal and B1 unseal, one CUDA source with a mode flag)."""
