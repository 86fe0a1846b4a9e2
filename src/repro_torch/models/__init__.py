"""The model plane of the port (``repro.models``'s prefill path): configs,
parameter tables, layers, attention, Mamba, MoE and the block-pattern
model, with the flash-attention and selective-scan kernels swapped in
on the card."""
