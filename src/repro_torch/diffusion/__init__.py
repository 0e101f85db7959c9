"""DDPM/DDIM schedule and the CFG sampler of the port."""
