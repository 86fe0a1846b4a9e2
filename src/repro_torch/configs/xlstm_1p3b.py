"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H d_ff=0 (no separate FFN: mLSTM blocks carry a 2x
up-projection, sLSTM blocks a 4/3 gated FFN) vocab=50304.  Block mix is
xLSTM[7:1]: one sLSTM slot per 8 (the paper places sparse sLSTM blocks
among mLSTM ones; exact positions are an unverified detail)."""
from repro_torch.models.config import MLSTM, NONE, SLSTM, ModelConfig

_PATTERN = ((SLSTM, NONE),) + ((MLSTM, NONE),) * 7

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_head=512,
    d_ff=0, vocab=50304,
    pattern=_PATTERN,
    mlstm_proj_factor=2.0, slstm_ff=2688, mlstm_chunk=256, conv_kernel=4,
    compute_dtype="bfloat16", grad_accum=8,
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=0, vocab=512,
    pattern=_PATTERN,
    mlstm_proj_factor=2.0, slstm_ff=96, mlstm_chunk=16, conv_kernel=4,
    remat=False,
)
