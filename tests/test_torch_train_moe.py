"""Training the MoE archs against the JAX package on the CPU
(``tests/train_parity.py`` sets out the run and the bounds):
qwen2-moe-a2.7b (4 shared experts, qkv bias) and deepseek-v3-671b (MLA at
qk head_dim 192, the MoE with its shared expert, and the MTP head, whose
loss enters at ``MTP_LOSS_WEIGHT``), each under ``none`` and ``int8_ef``,
``aux`` and ``mtp`` held with the loss."""
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
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_train_steps_match_the_reference(arch, method):
    check_train_steps(arch, method)
