"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=29568 vocab=152064.
The transformer BACKBONE only — the vision tower is a STUB per the
assignment: ``input_specs()`` provides precomputed patch/text embeddings
(``embed_inputs=True``); M-RoPE runs with the (t, h, w) position streams
(equal streams for text — the stub path)."""
from repro_torch.models.config import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=29568, vocab=152064,
    pattern=((ATTN, DENSE),),
    rope_theta=1e6, mrope=True, mrope_sections=(16, 24, 24),
    embed_inputs=True,
    compute_dtype="bfloat16", grad_accum=16,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    pattern=((ATTN, DENSE),),
    rope_theta=1e6, mrope=True, mrope_sections=(4, 2, 2),
    embed_inputs=True,
    remat=False,
)
