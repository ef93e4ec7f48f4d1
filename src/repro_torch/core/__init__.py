"""Proximity-graph MIPS (ip-NSW / ip-NSW+) in PyTorch.

Import from the submodules (``repro_torch.core.ipnsw``, ``.ipnsw_plus``,
``.brute_force``, ...): the kernels import ``core.similarity``, so this
package imports nothing itself.
"""
