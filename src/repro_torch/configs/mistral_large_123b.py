"""mistral-large-123b [dense] — [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8, head_dim=128) d_ff=28672 vocab=32768."""
from repro_torch.models.config import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab=32768,
    pattern=((ATTN, DENSE),),
    rope_theta=1e6,
    compute_dtype="bfloat16", grad_accum=16,
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=512,
    pattern=((ATTN, DENSE),),
    rope_theta=1e6,
    remat=False,
)
