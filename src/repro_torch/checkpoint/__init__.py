from repro_torch.checkpoint.io import load, load_metadata, save  # noqa: F401
