"""Continuous-batching diffusion serving for the port."""
