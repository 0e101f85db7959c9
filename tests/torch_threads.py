"""One PyTorch intra-op thread per test process.

The suite runs in several worker processes at once (pytest-xdist, six in
the tier-1 command), and PyTorch starts one intra-op thread per core in
each of them, so the workers' threads oversubscribe the machine and wait
on one another: the port's tests of many small operations (a few dozen
train steps of a reduced model) ran tens of times slower than alone.
Every ``tests/test_torch_*.py`` imports this module first, so each
process runs the port's CPU tests single-threaded, as many at once as
there are workers."""
import torch

torch.set_num_threads(1)
