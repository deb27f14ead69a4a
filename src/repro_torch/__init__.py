"""repro_torch — the FQA PPA activation datapath and the model that serves
it, in PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``repro`` is the reference this port is held against; the
port imports nothing of it (its tests import both)."""
