"""The grouped-conv nets of the CNN zoo (ResNeXt29_2x64d at groups 2,
RegNetX_200MF at groups w / 8, DPN92 at groups 32 and the zoo's largest,
34.24 M parameters) held against the JAX package as
``test_torch_cnn_zoo.py`` holds the others, in a file of their own so
that no file holds a worker for much more than a minute."""
import pytest

from test_torch_cnn_zoo import GROUPED, check_zoo_member
from test_torch_cnn_zoo import check_zoo_member_fp32
from lm_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", GROUPED)
def test_zoo_member_matches_jax(name):
    check_zoo_member(name)


@pytest.mark.parametrize("name", GROUPED)
def test_zoo_member_fp32_forward_matches_jax(name):
    check_zoo_member_fp32(name)
