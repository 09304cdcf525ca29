"""The one-thread autouse fixture of the PyTorch port's test modules.

Each `tests/test_torch_*.py` module imports `one_torch_thread`, which pytest
then applies to every test of that module. The suite runs in parallel
worker processes, and torch's default of one intra-op thread per core in
each of them oversubscribes the CPU and slows the whole run, the JAX
package's timed tests included."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side of each comparison."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
