"""gemma3-27b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3 family].

62L d_model=5376 32H (kv=16, head_dim=128) d_ff=21504 vocab=262144.
Sliding window 1024 on local layers; RoPE theta 1e6 global / 1e4 local;
QK-norm; gemma (1+g) RMSNorm; tied embeddings scaled by sqrt(d_model).
62 = 2 + 10*6: two leading local layers, then ten (5 local + 1 global)
periods — preserving the 5:1 ratio and a final global layer."""
from repro_torch.models.config import ATTN, ATTN_LOCAL, DENSE, ModelConfig

_PERIOD = ((ATTN_LOCAL, DENSE),) * 5 + ((ATTN, DENSE),)

CONFIG = ModelConfig(
    name="gemma3-27b",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=21504, vocab=262144,
    prefix=((ATTN_LOCAL, DENSE),) * 2,
    pattern=_PERIOD,
    rope_theta=1e6, rope_theta_local=1e4, window=1024,
    qk_norm=True, gemma_norm=True, scale_embed=True, tie_embeddings=True,
    mlp_act="gelu",
    compute_dtype="bfloat16", grad_accum=16,
)

SMOKE = ModelConfig(
    name="gemma3-27b-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    prefix=((ATTN_LOCAL, DENSE),) * 2,
    pattern=_PERIOD,
    rope_theta=1e6, rope_theta_local=1e4, window=16,
    qk_norm=True, gemma_norm=True, scale_embed=True, tie_embeddings=True,
    mlp_act="gelu",
    remat=False,
)
