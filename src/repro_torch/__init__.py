"""PyTorch / CUDA port of the proximity-graph MIPS system (ip-NSW, ip-NSW+)
for one NVIDIA H100, beside the JAX package ``repro``, which stays the
reference.  Importing it imports neither JAX nor ``repro``."""
