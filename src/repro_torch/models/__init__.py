"""Model substrate: the LM transformers (``transformer``, ``moe``,
``layers``), the recsys towers (``models.recsys``) and MeshGraphNet (``gnn``,
with its fanout ``sampler``), each served and trained on the card."""
