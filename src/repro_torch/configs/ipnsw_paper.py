"""The paper's own serving configuration: ip-NSW / ip-NSW+ index parameters
used by benchmarks and the serving examples (paper §5: angular graph fixed at
M=10, l=10; inner-product graph M/ef as tuned per dataset)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperIndexConfig:
    max_degree: int = 16          # M for the inner-product graph
    ef_construction: int = 64     # l during construction
    ang_degree: int = 10          # paper: fixed, no tuning
    ang_ef: int = 10
    k_angular: int = 10
    k: int = 10                   # top-10 MIPS throughout the paper
    insert_batch: int = 256


PAPER_INDEX = PaperIndexConfig()
