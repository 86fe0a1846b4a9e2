"""Dispatch wrapper of the chunkwise mLSTM.

``mlstm_chunkwise()`` is what the model plane's ``mlstm_block`` calls:
the CUDA kernel (``kernel.mlstm_chunkwise_call``) for tensors on the
card, the plain torch version (``ref.mlstm_chunkwise_ref``) for tensors
on the CPU or with ``use_kernel=False``.  The kernel starts from the zero
state, as prefill does; a carried state on the card raises.

With an input that requires grad (training, from the zero state), the
call goes through :class:`MLSTMChunkwiseFn`, whose backward is the plain
version's gradient.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import wants_kernel
from repro_torch.kernels.mlstm_chunk.ref import State, mlstm_chunkwise_ref


def _zero_state_call(q, k, v, i_raw, f_raw, chunk, use_kernel):
    if wants_kernel(use_kernel, q):
        from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunkwise_call
        return mlstm_chunkwise_call(q, k, v, i_raw, f_raw, chunk=chunk)
    return mlstm_chunkwise_ref(q, k, v, i_raw, f_raw, None, chunk)


class MLSTMChunkwiseFn(torch.autograd.Function):
    """The chunkwise mLSTM from the zero state with a gradient.  Forward:
    the kernel on the card (its plain version on the CPU or with
    ``use_kernel=False``); it saves q, k, v and the gates and returns h
    and the final C, n, m.  Backward: the plain version's gradient —
    ``mlstm_chunkwise_ref`` recomputed on the saved inputs under autograd,
    then ``torch.autograd.grad`` over the outputs that received a
    gradient (a final state nobody read gets None, which counts as zero).
    ``repro``'s training differentiates the same plain chunkwise form; it
    has no backward kernel, so this is the design, not a fallback."""

    @staticmethod
    def forward(ctx, q, k, v, i_raw, f_raw, chunk, use_kernel):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i_raw, f_raw)
        h, (C, n, m) = _zero_state_call(q, k, v, i_raw, f_raw, chunk,
                                        use_kernel)
        return h, C, n, m

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            h, (C, n, m) = mlstm_chunkwise_ref(*ins, None, ctx.chunk)
            outs = [(o, g) for o, g in zip((h, C, n, m), grads)
                    if g is not None]
            got = iter(torch.autograd.grad(
                [o for o, _ in outs], [t for t in ins if t.requires_grad],
                [g for _, g in outs], allow_unused=True))
        return (*(next(got) if n else None for n in need), None, None)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_raw: torch.Tensor, f_raw: torch.Tensor,
                    state: Optional[State] = None, *, chunk: int = 256,
                    use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, State]:
    """q, k, v: (B, H, L, Dh); i_raw, f_raw: (B, H, L); ``state`` (C, n,
    m) to start from, None for the zero state.  Returns h (B, H, L, Dh)
    and the final (C, n, m).  From the zero state with grad enabled and
    an input that requires it, :class:`MLSTMChunkwiseFn` carries the
    gradient; a carried state runs the plain version under autograd."""
    if state is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, i_raw, f_raw)):
        h, C, n, m = MLSTMChunkwiseFn.apply(q, k, v, i_raw, f_raw, chunk,
                                            use_kernel)
        return h, (C, n, m)
    if wants_kernel(use_kernel, q):
        if state is not None:
            raise ValueError("the mlstm_chunkwise kernel starts from the "
                             "zero state (prefill): pass state=None")
        return _zero_state_call(q, k, v, i_raw, f_raw, chunk, use_kernel)
    return mlstm_chunkwise_ref(q, k, v, i_raw, f_raw, state, chunk)
