"""Cache core of the port: saliency, chi^2 gate, linear approximators,
cache policies and the ``CachedDiT`` runner."""
