"""Recommender towers whose serving stage is the paper's MIPS problem:
SASRec, MIND, DIEN and DLRM, and the EmbeddingBag they share."""
from repro_torch.models.recsys.embedding import (
    embedding_bag,
    embedding_bag_ragged,
    multi_table_lookup,
)

__all__ = ["embedding_bag", "embedding_bag_ragged", "multi_table_lookup"]
