"""The port's CPU tests run torch's CPU operators on one thread a process.

Tier-1 runs under pytest-xdist with six workers on the machine's cores,
and torch's default intra-op pool takes a thread a core in every worker:
the workers' pools oversubscribe the cores and the small operators of
these tests spend most of their time in the pools' hand-offs. Measured on
one 8-core machine under the tier-1 command, the port's test files summed
4525.9 s of test time with the default and 1150.0 s on one thread, with
the same tests passing. Importing this module sets it; every port test
file imports it (JAX's own thread pool is untouched)."""
import torch

torch.set_num_threads(1)
