"""The plain reference: float32 torch, no kernels, nothing of the program."""
