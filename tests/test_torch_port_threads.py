"""The port test files' shared thread setting. Each file imports
``one_thread``, an autouse fixture, so its tests run PyTorch on one intra-op
thread: the suite runs several xdist workers on the same cores, and
PyTorch's default of one thread per core oversubscribes them many times
over.

    from test_torch_port_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the importing file runs; the old count
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_while_a_port_file_runs():
    assert torch.get_num_threads() == 1
