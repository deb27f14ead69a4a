"""repro_torch — the FQA compiler (fit, full-space candidate scan on the
card, TBW segmentation, the table store), the PPA activation datapath and
the models that serve it, in PyTorch with hand-written CUDA kernels for
Hopper.

The JAX package ``repro`` is the reference this port is held against; the
port imports nothing of it (its tests import both)."""
