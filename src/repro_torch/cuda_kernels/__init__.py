"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

Nothing is compiled at import: a kernel's library is built with ``nvcc``
at its first launch (``build.py``).  The package is not named ``kernels``:
the reference's lint (``tools/reprolint``, kernel-parity) keys every
module under a ``/kernels/`` directory of ``src/`` by its short name, and
this package's ``ref`` and ``fused_gate`` would shadow the
reference's.
"""
