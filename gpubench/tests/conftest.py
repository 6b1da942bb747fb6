import pytest
import torch


@pytest.fixture
def card():
    """The card, for the tests marked ``gpu``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
