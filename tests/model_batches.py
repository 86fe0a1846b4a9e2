"""The prompt batch the port's model tests share (imports neither JAX
nor ``repro``, so the ``cuda`` tests can use it on a machine without
them)."""

import numpy as np


def batch_np(cfg, B, L, seed):
    """One prompt batch as numpy, the modality's input: token ids (B, L),
    codebook ids (B, L, K) or embeddings (B, L, d_model) ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return {"embeds": rng.standard_normal(
            (B, L, cfg.d_model)).astype(np.float32)}
    shape = (B, L, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, L)
    return {"tokens": rng.integers(0, cfg.vocab, shape)}
