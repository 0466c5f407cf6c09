"""The port's test modules' shared fixture: each imports it, and pytest
runs it around the module's tests."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the tensors here are small, and a thread
    pool a test worker only contends with the other workers' pools."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
