"""Architecture registry of the PyTorch port: ``--arch <id>`` resolution.

Eight of the JAX package's ten families are listed: ``musicgen-medium``
and ``zamba2-1.2b`` need model code of their own and join with their own
slices (see ROADMAP.md)."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, gemma2_27b,
                                 h2o_danube3_4b, llava_next_34b, mamba2_370m,
                                 phi35_moe, smollm_135m, stablelm_1_6b)
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, Shape

ARCH_SPECS: dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in (
        smollm_135m.SPEC,
        h2o_danube3_4b.SPEC,
        stablelm_1_6b.SPEC,
        gemma2_27b.SPEC,
        phi35_moe.SPEC,
        deepseek_v2_236b.SPEC,
        llava_next_34b.SPEC,
        mamba2_370m.SPEC,
    )
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_SPECS:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(ARCH_SPECS)}")
    return ARCH_SPECS[arch_id]
