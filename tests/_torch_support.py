"""Shared fixtures of the PyTorch-port parity tests (``test_torch_*``)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port's many tiny CPU tensor ops on one intra-op thread:
    with several test workers sharing the machine, torch's default thread
    pool turns a microsecond op into milliseconds of contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def require_cuda():
    """Skip the calling test where there is no CUDA device (decided at run
    time, never at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
