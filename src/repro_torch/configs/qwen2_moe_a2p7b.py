"""qwen2-moe-a2.7b [moe] — [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) vocab=151936; every layer MoE: 4 shared
(fused 5632-wide shared expert with a sigmoid gate) + 60 routed, top-4,
expert width 1408, top-k probs NOT renormalized (norm_topk_prob=false)."""
from repro_torch.models.config import ATTN, MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151936,
    pattern=((ATTN, MOE),),
    rope_theta=1e6,
    n_experts=60, n_shared=4, top_k=4, d_expert=1408,
    shared_gate=True, renorm_topk=False, capacity_factor=1.5,
    compute_dtype="bfloat16", grad_accum=8,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=32, vocab=512,
    pattern=((ATTN, MOE),),
    rope_theta=1e6,
    n_experts=6, n_shared=4, top_k=2, d_expert=32,
    shared_gate=True, renorm_topk=False, capacity_factor=3.0,  # drop-free
    remat=False,
)
