"""Model substrate.  Ported: the LM transformers (``transformer``, ``moe``,
``layers``; serving, and the loss's value) and the recsys towers
(``models.recsys``); the LM backward and the GNN wait for their slices
(ROADMAP Queue 1)."""
