"""The depthwise nets of the CNN zoo (MobileNet, MobileNetV2,
ShuffleNetV2, EfficientNetB0; their strided depthwise convolutions pad
as XLA's SAME does, (0, 1)) held against the JAX package as
``test_torch_cnn_zoo.py`` holds the others.  JAX's float64 depthwise
convolutions are slow on the CPU (MobileNetV2 about 20 s), hence a file
of their own."""
import pytest

from test_torch_cnn_zoo import DEPTHWISE, check_zoo_member
from test_torch_cnn_zoo import check_zoo_member_fp32
from lm_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", DEPTHWISE)
def test_zoo_member_matches_jax(name):
    check_zoo_member(name)


@pytest.mark.parametrize("name", DEPTHWISE)
def test_zoo_member_fp32_forward_matches_jax(name):
    check_zoo_member_fp32(name)
