"""gemma3-1b [dense] — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (kv=1, head_dim=256) d_ff=6912 vocab=262144.
Sliding window 512.  26 = 2 + 4*6."""
from repro_torch.models.config import ATTN, ATTN_LOCAL, DENSE, ModelConfig

_PERIOD = ((ATTN_LOCAL, DENSE),) * 5 + ((ATTN, DENSE),)

CONFIG = ModelConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_head=256,
    d_ff=6912, vocab=262144,
    prefix=((ATTN_LOCAL, DENSE),) * 2,
    pattern=_PERIOD,
    rope_theta=1e6, rope_theta_local=1e4, window=512,
    qk_norm=True, gemma_norm=True, scale_embed=True, tie_embeddings=True,
    mlp_act="gelu",
    compute_dtype="bfloat16", grad_accum=4,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
    d_ff=128, vocab=512,
    prefix=((ATTN_LOCAL, DENSE),) * 2,
    pattern=_PERIOD,
    rope_theta=1e6, rope_theta_local=1e4, window=16,
    qk_norm=True, gemma_norm=True, scale_embed=True, tie_embeddings=True,
    mlp_act="gelu",
    remat=False,
)
