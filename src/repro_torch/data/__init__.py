"""repro_torch.data — deterministic synthetic stream + memmap token
dataset (numpy; the launcher moves batches to the device)."""

from .memmap import TokenFileDataset, write_token_file
from .synthetic import SyntheticLM

__all__ = ["TokenFileDataset", "write_token_file", "SyntheticLM"]
