"""Arch registry: ``--arch <id>`` resolves here.  The ten ids are the JAX
package's; the LM and recsys families are ported, the GNN family raises
``NotImplementedError`` until its slice (ROADMAP Queue 1, item 6)."""
import importlib

_MODULES = {
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "meshgraphnet": None,
    "sasrec": "repro_torch.configs.sasrec",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "mind": "repro_torch.configs.mind",
    "dien": "repro_torch.configs.dien",
}

ARCH_IDS = list(_MODULES)
PORTED_ARCH_IDS = [a for a, m in _MODULES.items() if m is not None]


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if _MODULES[arch_id] is None:
        raise NotImplementedError(
            f"{arch_id}: the GNN family is not ported yet (ROADMAP Queue 1, item 6)")
    return importlib.import_module(_MODULES[arch_id]).ARCH


def all_cells():
    """Every (arch, shape) pair of the ported archs."""
    return [(aid, shape) for aid in PORTED_ARCH_IDS for shape in get_arch(aid).shape_names()]
