"""DenseNet121 and GoogLeNet, the zoo's costliest cases after DPN92,
held against the JAX package as ``test_torch_cnn_zoo.py`` holds the
others, in a file of their own so that no file holds a worker for much
more than a minute."""
import pytest

from test_torch_cnn_zoo import HEAVY, check_zoo_member
from test_torch_cnn_zoo import check_zoo_member_fp32
from lm_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", HEAVY)
def test_zoo_member_matches_jax(name):
    check_zoo_member(name)


@pytest.mark.parametrize("name", HEAVY)
def test_zoo_member_fp32_forward_matches_jax(name):
    check_zoo_member_fp32(name)
