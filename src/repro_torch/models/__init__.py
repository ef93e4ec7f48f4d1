"""Model substrate.  Ported: the recsys towers (``models.recsys``) and the
dense-stack part of ``layers``; the LM transformers, MoE and the GNN wait
for their slices (ROADMAP Queue 1)."""
