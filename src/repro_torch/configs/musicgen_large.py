"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32, head_dim=64) d_ff=8192 vocab=2048 per
codebook, 4 codebooks (delay pattern is data-prep, handled by the stubbed
EnCodec frontend); sinusoidal positions, plain GELU MLP.  The transformer
BACKBONE only — EnCodec audio<->token codecs are a STUB per the
assignment: ``input_specs()`` provides token frames."""
from repro_torch.models.config import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048,
    pattern=((ATTN, DENSE),),
    pos_emb="sinusoidal", mlp_gated=False, mlp_act="gelu",
    n_codebooks=4,
    compute_dtype="bfloat16", grad_accum=4,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=128,
    pattern=((ATTN, DENSE),),
    pos_emb="sinusoidal", mlp_gated=False, mlp_act="gelu",
    n_codebooks=4,
    remat=False,
)
