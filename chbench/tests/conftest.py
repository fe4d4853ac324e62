import pytest
import torch

from .tiny import make_root


@pytest.fixture(scope='session')
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp('chbench'))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', torch.cuda.current_device())


@pytest.fixture(autouse=True, scope='session')
def _few_threads():
    # test workers share the machine's cores
    torch.set_num_threads(2)
