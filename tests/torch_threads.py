"""The thread policy of the port's CPU tests, in one place.

Every ``tests/test_torch_*.py`` takes the fixture by name::

    from torch_threads import one_thread  # noqa: F401  (an autouse fixture)

and ``test_torch_sym_and_ops.py`` checks that each does.  Rank processes
that a test file spawns set their own thread count under its ``__main__``
guard, which no fixture reaches.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while a file of these tests runs: their samplers
    and solvers are loops of small operations, which a thread pool only
    slows, and more so on a machine busy with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
