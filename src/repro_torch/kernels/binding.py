"""What every kernel wrapper of the port shares: the launch counts, the
dtype codes of the C interface, the argument check and the pointer helper.

``LAUNCHES`` holds plain integers, by kernel and mode.  Each wrapper adds
one to its count where it launches its kernel, and nowhere else (the
plain versions never touch them); ``merge`` counts the standalone
merge, ``merge_fused`` the split sweeps' launches that merged their own
splits (a sweep's own key counts them too).  A run zeroes them with
:func:`reset_launches` and reads them after, to show which kernels its
path went through."""
from __future__ import annotations

import torch

LAUNCHES = {"sweep_decode": 0, "sweep_verify": 0, "merge": 0,
            "merge_fused": 0,
            "ring_decode": 0, "ring_verify": 0, "flash_attention": 0,
            "rmsnorm": 0, "ssd": 0, "flash_attention_bwd": 0,
            "rmsnorm_bwd": 0, "mla_decode": 0, "mla_verify": 0,
            "sweep_decode_int8": 0, "sweep_verify_int8": 0,
            "ring_decode_int8": 0, "ring_verify_int8": 0}

# the C interface's dtype argument
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check(name, t, *, dtype, shape, device, vector=False):
    """Raise unless ``t`` is what the kernel takes; ``vector`` tensors are
    read with 16-byte loads, so their base must be 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if vector and t.data_ptr() % 16:
        raise ValueError(f"{name}: base address not 16-byte aligned")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where a kernel that has no backward would be launched on a
    CUDA tensor that requires grad with grad mode on: its output would cut
    the gradient without a word.  ``None`` entries are skipped."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: no backward kernel (not ported "
                           "yet): call it under torch.no_grad(), or on "
                           "inputs that do not require grad")
