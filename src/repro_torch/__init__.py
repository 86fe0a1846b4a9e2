"""PyTorch/CUDA port of the multi-tenant pub/sub stream engine.

The JAX package ``repro`` is the reference; this package imports nothing
of it (nor of ``jax``).  The engine runs on a CUDA device by default, with
hand-written Hopper kernels for its hot path (``repro_torch.kernels``),
and on the CPU through the kernels' plain torch versions when asked
(``device="cpu"``)."""
from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import __all__  # noqa: F401
