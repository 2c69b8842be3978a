"""Training the recurrent families against the JAX package on the CPU
(``tests/train_parity.py`` sets out the run and the bounds): rwkv6-3b
(time-mix and channel-mix, the WKV6 through ``wkv6_ref``) and
jamba-v0.1-52b (one period of 16 layers at smoke size: the selective
scan, attention, and the MoE and dense FFNs of its interleave), each
under ``none`` and ``int8_ef``."""
import pytest
import torch

from train_parity import check_train_steps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size ops are microseconds: threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["none", "int8_ef"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_train_steps_match_the_reference(arch, method):
    check_train_steps(arch, method)
