"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7, MoE [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; MoE 16 experts
top-2 on every other layer.  Each period of 8 layers has one attention
mixer (slot 4) and MoE MLPs on odd slots.  Jamba uses no explicit
positional encoding (the Mamba layers carry position information), so
``pos_emb='none'``."""
from repro_torch.models.config import ATTN, DENSE, MAMBA, MOE, ModelConfig

_PERIOD = (
    (MAMBA, DENSE), (MAMBA, MOE), (MAMBA, DENSE), (MAMBA, MOE),
    (ATTN, DENSE), (MAMBA, MOE), (MAMBA, DENSE), (MAMBA, MOE),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=65536,
    pattern=_PERIOD,
    pos_emb="none",
    n_experts=16, n_shared=0, top_k=2, d_expert=14336,
    renorm_topk=True, capacity_factor=1.5,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_chunk=256, ssm_norm=True,
    compute_dtype="bfloat16", grad_accum=16,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    pattern=_PERIOD,
    pos_emb="none",
    n_experts=4, n_shared=0, top_k=2, d_expert=64,
    renorm_topk=True, capacity_factor=2.0,
    ssm_state=8, ssm_conv=4, ssm_expand=2, ssm_chunk=16, ssm_norm=True,
    remat=False,
)
