"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=16384 vocab=256000.
Nemotron uses a plain (ungated) MLP with squared-ReLU activation."""
from repro_torch.models.config import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=256000,
    pattern=((ATTN, DENSE),),
    rope_theta=1e4,
    mlp_gated=False, mlp_act="relu2",
    compute_dtype="bfloat16", grad_accum=8,
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    pattern=((ATTN, DENSE),),
    rope_theta=1e4,
    mlp_gated=False, mlp_act="relu2",
    remat=False,
)
