"""DiT model for the PyTorch port."""
from repro_torch.models.dit import DiTModel

__all__ = ["DiTModel"]
