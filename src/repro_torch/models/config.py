"""Model-plane configuration (the port's copy of the JAX package's
``repro.models.config``, kept here so the port imports nothing of it).

One :class:`ModelConfig` describes an architecture as a cyclic *pattern*
of (mixer, mlp) layer specs — dense/GQA attention with global or
sliding-window masks, fine-grained MoE, Mamba, mLSTM and sLSTM mixers —
plus optional unscanned ``prefix`` layers (e.g. deepseek's first dense
layer, gemma3's leftover local layers) and the modality head
(multi-codebook for audio, embedding-stub inputs for VLM).  The fields
are ``repro``'s, so one configuration describes the same model in both
packages.  :class:`ShapeConfig` and ``SHAPES`` are ``repro``'s assigned
input-shape cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# mixer kinds
ATTN = "attn"              # global causal attention
ATTN_LOCAL = "attn_local"  # sliding-window causal attention
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"
# mlp kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"

LayerSpec = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...] = ((ATTN, DENSE),)
    prefix: Tuple[LayerSpec, ...] = ()     # leading unscanned layers

    # attention
    rope_theta: float = 1e6
    rope_theta_local: float = 1e4
    window: Optional[int] = None
    mrope: bool = False                    # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)   # sum == d_head//2
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    attn_chunk: int = 1024                 # q-chunk of the plain attend_causal

    # MoE
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0                      # routed expert hidden width
    d_ff_prefix: int = 0                   # dense-FFN width of prefix layers (0 -> d_ff)
    capacity_factor: float = 1.5
    router_aux_coef: float = 0.01
    renorm_topk: bool = True
    shared_gate: bool = False              # qwen2-moe sigmoid shared-expert gate
    moe_group: int = 0                     # dispatch group size (0 -> auto)

    # Mamba
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                   # 0 -> ceil(d_model/16)
    ssm_chunk: int = 256
    ssm_norm: bool = False                 # jamba dt/B/C RMSNorm
    ssm_mode: str = "assoc"                # assoc | seq (training forms in repro)

    # xLSTM
    mlstm_proj_factor: float = 2.0
    slstm_ff: int = 0                      # sLSTM post-FFN width (0 -> none)
    mlstm_chunk: int = 256
    conv_kernel: int = 4

    # modality
    n_codebooks: int = 1                   # musicgen: 4 EnCodec books
    embed_inputs: bool = False             # qwen2-vl: input_specs provides embeddings
    pos_emb: str = "rope"                  # rope | sinusoidal | none
    mlp_gated: bool = True                 # SwiGLU vs plain 2-matmul MLP
    mlp_act: str = "silu"

    # general
    tie_embeddings: bool = False
    scale_embed: bool = False              # gemma: x *= sqrt(d_model)
    gemma_norm: bool = False               # RMSNorm (1+g) convention
    norm_eps: float = 1e-6
    final_logit_softcap: Optional[float] = None
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    grad_accum: int = 1                    # microbatches per train step
    unroll_layers: bool = False            # repro's dry-run lowering options;
    unroll_inner: bool = False             # the port's loops are Python loops

    # ------------------------------------------------------------------
    @property
    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        n_rest = self.n_layers - len(self.prefix)
        return self.prefix + tuple(
            self.pattern[i % len(self.pattern)] for i in range(n_rest))

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_scan(self) -> int:
        rem = self.n_layers - len(self.prefix)
        assert rem % self.period == 0, (
            f"{self.name}: {rem} layers not divisible by period {self.period}")
        return rem // self.period

    @property
    def d_inner(self) -> int:              # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def d_mlstm(self) -> int:              # mlstm inner width
        return int(self.mlstm_proj_factor * self.d_model)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def n_params(self) -> int:
        from repro_torch.models.model import count_params    # lazy import
        return count_params(self)

    def n_active_params(self) -> int:
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)

    def validate(self) -> "ModelConfig":
        assert self.n_heads % self.n_kv_heads == 0
        _ = self.n_scan
        for mixer, mlp in self.prefix + self.pattern:
            assert mixer in (ATTN, ATTN_LOCAL, MAMBA, MLSTM, SLSTM), mixer
            assert mlp in (DENSE, MOE, NONE), mlp
        if any(m == MOE for _, m in self.pattern):
            assert self.n_experts > 0 and self.top_k > 0 and self.d_expert > 0
        if self.mrope:
            assert sum(self.mrope_sections) == self.d_head // 2
        if any(m == ATTN_LOCAL for m, _ in self.layer_specs):
            assert self.window is not None
        return self

    def has_mixer(self, kind: str) -> bool:
        return any(m == kind for m, _ in self.layer_specs)

    @property
    def long_context_ok(self) -> bool:
        """Criterion for the long_500k shape: archs with recurrent or
        sliding-window mixers run (sub-quadratic state growth); *pure*
        global full-attention archs skip."""
        return any(m in (MAMBA, MLSTM, SLSTM, ATTN_LOCAL)
                   for m, _ in self.layer_specs)

    @property
    def pure_recurrent(self) -> bool:
        return not any(m in (ATTN, ATTN_LOCAL) for m, _ in self.layer_specs)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
