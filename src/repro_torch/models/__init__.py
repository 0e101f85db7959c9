"""Models of the PyTorch port: the DiT and the LM (dense, MoE, SSM and
hybrid families)."""
from repro_torch.models.dit import DiTModel
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import TransformerModel

__all__ = ["DiTModel", "TransformerModel", "build_model"]
