"""deepseek-moe-16b [moe] — fine-grained MoE [arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16) vocab=102400; layer 0 is a dense 10944-wide
FFN, layers 1..27 are MoE: 2 shared + 64 routed experts, top-6, expert
width 1408."""
from repro_torch.models.config import ATTN, DENSE, MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=10944, vocab=102400,
    prefix=((ATTN, DENSE),),
    pattern=((ATTN, MOE),),
    rope_theta=1e4,
    n_experts=64, n_shared=2, top_k=6, d_expert=1408,
    renorm_topk=True, capacity_factor=1.5,
    compute_dtype="bfloat16", grad_accum=8,
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=160, vocab=512,
    prefix=((ATTN, DENSE),),
    pattern=((ATTN, MOE),),
    rope_theta=1e4,
    n_experts=8, n_shared=2, top_k=2, d_expert=32,
    renorm_topk=True, capacity_factor=4.0,   # drop-free at smoke scale
    remat=False,
)
