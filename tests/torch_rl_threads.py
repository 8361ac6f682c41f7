"""torch on one intra-op thread for the RL test modules (an autouse,
module-scoped fixture: a module imports ``one_intra_op_thread``).

Their learners run long chains of tiny products. With the suite's
workers sharing the host's cores, a pool of one thread a core waits on
descheduled threads at every parallel region: SAC's learning check took
620 s beside the other workers against 3.7 s alone."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
