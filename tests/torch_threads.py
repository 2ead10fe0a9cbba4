"""One intra-op thread per test process for the port's tests on the CPU.

The suite runs several pytest workers to a machine (xdist). PyTorch's
default of one intra-op thread per core makes each worker's small tensor
ops fan out over every core, and its idle threads spin between ops, so
the workers starve each other and the JAX compiles beside them. One thread
a process keeps each worker to its own core. Importing this module sets it
for the process; the port's test modules and their helpers import it.
"""

import torch

torch.set_num_threads(1)
