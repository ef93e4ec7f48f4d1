from repro_torch.data.synthetic import mips_dataset, mips_queries

__all__ = ["mips_dataset", "mips_queries"]
