"""The recsys cells' small configs that tests/_torch_mesh_ranks.py (the
port's ranks) and tests/_torch_mesh_jax.py (the JAX package's reference run)
both build, so the two sides cannot drift: each arch's published config with
these fields (n_items / n_rows divisible by the 4 model ranks)."""
RECSYS_CFGS = {"sasrec": dict(embed_dim=16, seq_len=8, n_items=64),
               "mind": dict(embed_dim=16, seq_len=8, n_items=64),
               "dien": dict(embed_dim=8, seq_len=6, gru_dim=12, mlp=(16, 8), n_items=64),
               "dlrm-rm2": dict(n_sparse=4, embed_dim=8, n_rows=64, bot_mlp=(16, 8),
                                top_mlp=(16, 1))}
# the AdamW step the train cells start from (with drawn moments): past the
# cells' warmup of 500, so the learning rate is not 0 and the parameters move
RECSYS_STEP = 600
