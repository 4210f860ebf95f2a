"""Architecture registry of the PyTorch port: ``--arch <id>`` resolution.

Only the families whose serving path has been ported are listed; the
others join with their own slices (see ROADMAP.md)."""
from __future__ import annotations

from repro_torch.configs import smollm_135m
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, Shape

ARCH_SPECS: dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in (
        smollm_135m.SPEC,
    )
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_SPECS:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(ARCH_SPECS)}")
    return ARCH_SPECS[arch_id]
