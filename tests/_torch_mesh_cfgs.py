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

# the LM cells' small configs (TransformerConfig fields, fp32 on both sides):
# a dense one with a (window, None) pattern and an MoE one, 8 q heads over 2
# kv heads (2 of a group of 4 a rank on 4 model ranks, a whole group on 2),
# the vocabulary divisible by the 4 model ranks; a loss chunk of 8 puts the
# cross-entropy in chunks; the MoE's capacity factor of 16 drops no token on
# a rank or unsharded, so the unsharded cell is a second oracle (the MoE
# dispatch's drops are held to JAX's in tests/test_torch_mesh.py's MoE tests)
LM_CFGS = {"dense": dict(name="dense", n_layers=4, d_model=32, n_heads=8, n_kv=2, head_dim=8,
                         d_ff=64, vocab=64, window_pattern=(8, None), loss_chunk=8),
           "moe": dict(name="moe", n_layers=2, d_model=32, n_heads=8, n_kv=2, head_dim=8,
                       d_ff=32, vocab=64, moe_experts=4, moe_top_k=2, capacity_factor=16.0,
                       loss_chunk=8)}
# the meshes both sides run them on: name -> (shape, axis names)
LM_MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# each LM cell's batch and sequence (decode: its caches' length); long_500k
# decodes one row over caches cut over every axis
LM_SHAPES = {"train_4k": dict(kind="train", seq=16, batch=8),
             "prefill_32k": dict(kind="prefill", seq=16, batch=8),
             "decode_32k": dict(kind="decode", seq=16, batch=8),
             "long_500k": dict(kind="decode", seq=16, batch=1)}
# the AdamW step the LM train cells start from: past their 2,000-step warmup
LM_STEP = 2400
# decode positions: at 5 the ring (8 slots) has not wrapped and the global
# cache's last slices hold no valid slot; at 11 the ring has wrapped and the
# global cache's last slice (4 or 2 slots a rank) still holds none
LM_DECODE_OFFSETS = (5, 11)
