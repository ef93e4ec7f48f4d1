from repro_torch.data.synthetic import (
    SyntheticClickStream,
    SyntheticLMStream,
    mips_dataset,
    mips_queries,
)

__all__ = ["SyntheticClickStream", "SyntheticLMStream", "mips_dataset", "mips_queries"]
