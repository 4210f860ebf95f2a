"""Architecture registry of the PyTorch port: ``--arch <id>`` resolution.

All ten of the JAX package's LM architectures are listed, with the same
ids, configs and smoke reductions."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, gemma2_27b,
                                 h2o_danube3_4b, llava_next_34b, mamba2_370m,
                                 musicgen_medium, phi35_moe, smollm_135m,
                                 stablelm_1_6b, zamba2_1_2b)
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, Shape

ARCH_SPECS: dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in (
        smollm_135m.SPEC,
        h2o_danube3_4b.SPEC,
        stablelm_1_6b.SPEC,
        gemma2_27b.SPEC,
        musicgen_medium.SPEC,
        phi35_moe.SPEC,
        deepseek_v2_236b.SPEC,
        llava_next_34b.SPEC,
        mamba2_370m.SPEC,
        zamba2_1_2b.SPEC,
    )
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_SPECS:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(ARCH_SPECS)}")
    return ARCH_SPECS[arch_id]
