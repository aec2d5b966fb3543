"""One torch intra-op thread in every process that runs the port's tests.

Every ``tests/test_torch_*.py`` imports this module, so whichever of them
a test process collects first sets it. The test runner's xdist workers
share the machine's cores and each worker collects every module: with
torch's default pool, one thread per core in every worker, the port's
tests of many small torch ops ran up to 100 times slower under the
suite's load than alone, and with one thread each they run about as fast
as alone. A test that needs more threads raises the count in its own
body. Subprocesses that the tests start are set by their own environment
(``OMP_NUM_THREADS``, ``YAWT_NUM_THREADS``), not by this module.
"""

import torch

torch.set_num_threads(1)
