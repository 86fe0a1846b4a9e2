"""Dispatch wrapper of the chunkwise mLSTM.

``mlstm_chunkwise()`` is what the model plane's ``mlstm_block`` calls:
the CUDA kernel (``kernel.mlstm_chunkwise_call``) for tensors on the
card, the plain torch version (``ref.mlstm_chunkwise_ref``) for tensors
on the CPU or with ``use_kernel=False``.  The kernel starts from the zero
state, as prefill does; a carried state on the card raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.mlstm_chunk.ref import State, mlstm_chunkwise_ref


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_raw: torch.Tensor, f_raw: torch.Tensor,
                    state: Optional[State] = None, *, chunk: int = 256,
                    use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, State]:
    """q, k, v: (B, H, L, Dh); i_raw, f_raw: (B, H, L); ``state`` (C, n,
    m) to start from, None for the zero state.  Returns h (B, H, L, Dh)
    and the final (C, n, m)."""
    if wants_kernel(use_kernel, q):
        if state is not None:
            raise ValueError("the mlstm_chunkwise kernel starts from the "
                             "zero state (prefill): pass state=None")
        from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunkwise_call
        return mlstm_chunkwise_call(q, k, v, i_raw, f_raw, chunk=chunk)
    return mlstm_chunkwise_ref(q, k, v, i_raw, f_raw, state, chunk)
