"""PyTorch/CUDA port of the FastCache DiT serving path.

The JAX package ``repro`` is the reference; this package mirrors its module
names and imports nothing of it (nor of JAX).  Entry points default to
``device="cuda"`` and raise without a card; ``device="cpu"`` runs the plain
PyTorch versions of the kernels.
"""
