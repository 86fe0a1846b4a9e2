"""Plain torch versions of the mLSTM cell: the chunkwise-parallel form
(the CPU path, and the plain version the CUDA kernel of
:mod:`repro_torch.kernels.mlstm_chunk.kernel` is held to on the card)
and the sequential stabilised recurrence in float64 (the oracle).

The chunkwise form is the port of the JAX package's
``models/xlstm.py::mlstm_chunkwise``, with a starting state; its float32
casts are casts to the wider of float32 and the input's type, so a
float64 input runs in float64 (the truth of ``chip_smoke.py``'s whole
prefill comparison) and float32 and bf16 inputs run exactly as before.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def init_mlstm_state(B: int, H: int, Dh: int, dtype=torch.float32,
                     device=None) -> State:
    """The zero state: C (B, H, Dh, Dh) and n (B, H, Dh) zero, m = NEG."""
    return (torch.zeros((B, H, Dh, Dh), dtype=dtype, device=device),
            torch.zeros((B, H, Dh), dtype=dtype, device=device),
            torch.full((B, H), NEG, dtype=dtype, device=device))


def chunk_len(chunk: int, L: int) -> int:
    """``repro``'s chunk rule: ``min(chunk, L)``, or the whole sequence
    when that does not divide L."""
    ck = min(chunk, L)
    return L if L % ck else ck


def mlstm_chunkwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_raw: torch.Tensor, f_raw: torch.Tensor,
                        state: Optional[State] = None, chunk: int = 256
                        ) -> Tuple[torch.Tensor, State]:
    """q, k, v: (B, H, L, Dh); i_raw, f_raw: (B, H, L); ``state`` (C, n,
    m) to start from, None for the zero state.  Per chunk: the stabilised
    decay matrix from the cumulative log forget gate, applied to q k^T,
    plus the carried state's term, then the state carried to the chunk's
    end.  Returns h (B, H, L, Dh) and the final (C, n, m), float32 (or
    float64 for float64 inputs)."""
    B, H, L, Dh = q.shape
    ck = chunk_len(chunk, L)
    wd = torch.promote_types(q.dtype, torch.float32)
    q = q.to(wd) * (Dh ** -0.5)
    k, v = k.to(wd), v.to(wd)
    i_raw, f_raw = i_raw.to(wd), f_raw.to(wd)
    C, n, m = (init_mlstm_state(B, H, Dh, wd, q.device) if state is None
               else tuple(s.to(wd) for s in state))
    tril = torch.ones((ck, ck), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c0 in range(0, L, ck):
        sl = slice(c0, c0 + ck)
        qc, kc, vc, ic = q[:, :, sl], k[:, :, sl], v[:, :, sl], i_raw[:, :, sl]
        lf = F.logsigmoid(f_raw[:, :, sl])
        b = torch.cumsum(lf, dim=-1)                         # (B, H, ck)
        a = b[..., :, None] - b[..., None, :] + ic[..., None, :]
        a = a.masked_fill(~tril, NEG)
        m_intra = torch.amax(a, dim=-1)
        m_t = torch.maximum(b + m[..., None], m_intra)        # (B, H, ck)
        Dm = torch.exp(a - m_t[..., None])                    # decay matrix
        SD = (qc @ kc.transpose(-1, -2)) * Dm
        num = SD @ vc
        inter = torch.exp(b + m[..., None] - m_t)
        num = num + inter[..., None] * (qc @ C.transpose(-1, -2))
        den = SD.sum(-1) + inter * (qc @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the state to the end of the chunk
        m_new = m_t[..., -1]
        wj = torch.exp(b[..., -1:] - b + ic - m_new[..., None])
        scale = torch.exp(b[..., -1] + m - m_new)
        C = scale[..., None, None] * C + (vc * wj[..., None]).transpose(-1, -2) @ kc
        n = scale[..., None] * n + (wj[..., None, :] @ kc)[..., 0, :]
        m = m_new
    return torch.cat(hs, dim=2), (C, n, m)


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              i_raw: torch.Tensor, f_raw: torch.Tensor, C0: torch.Tensor,
              n0: torch.Tensor, m0: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """The oracle: the stabilised recurrence (Beck et al. 2024, eqs.
    19-27) one step at a time in float64, on the inputs' device (the port
    of the JAX package's ``kernels/mlstm_chunk/ref.py::mlstm_ref``).
    Returns h (B, H, L, Dh) and the final (C, n, m), all float64."""
    q, k, v, i_raw, f_raw = (t.double() for t in (q, k, v, i_raw, f_raw))
    B, H, L, Dh = q.shape
    C, n, m = C0.double().clone(), n0.double().clone(), m0.double().clone()
    qs = q / Dh ** 0.5
    h = torch.empty((B, H, L, Dh), dtype=torch.float64, device=q.device)
    for t in range(L):
        lf = -torch.log1p(torch.exp(-f_raw[:, :, t]))
        m1 = torch.maximum(lf + m, i_raw[:, :, t])
        ip = torch.exp(i_raw[:, :, t] - m1)
        fp = torch.exp(lf + m - m1)
        C = fp[..., None, None] * C + ip[..., None, None] * (
            v[:, :, t, :, None] * k[:, :, t, None, :])
        n = fp[..., None] * n + ip[..., None] * k[:, :, t]
        m = m1
        den = torch.maximum((qs[:, :, t] * n).sum(-1).abs(), torch.exp(-m))
        h[:, :, t] = (C @ qs[:, :, t, :, None])[..., 0] / den[..., None]
    return h, (C, n, m)
