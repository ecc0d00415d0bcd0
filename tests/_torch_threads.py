"""One CPU thread for torch and the BLAS while a port test file runs.

The suite runs files in parallel worker processes, and a thread pool per
worker on the same cores slows these small-matrix loops many times over.
A file takes the fixture with one line::

    from _torch_threads import one_thread  # noqa: F401

and the previous settings come back after the file.
"""
import pytest
from threadpoolctl import threadpool_limits


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)
