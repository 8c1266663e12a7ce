import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips where "
                   "there is none")


@pytest.fixture(autouse=True)
def _few_threads():
    """The benchmark's tests run small CPU steps: two threads each, so
    workers running side by side do not crowd the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
