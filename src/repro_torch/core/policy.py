"""QoS policies — paper Sec III-C last paragraph.

In O-RAN, the A1 Policy Management Service pushes declarative policies from
the non-RT-RIC to the apps.  FROST consumes a small policy document that
selects the ED^mP exponent (and optional hard constraints) per use case:

    {"policy_id": "...", "edp_exponent": 2, "max_delay_increase": 0.10,
     "min_cap": 0.3, "scope": {"node": "...", "model": "..."}}
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class QoSPolicy:
    """Decision policy for cap selection."""
    policy_id: str = "default-ed2p"
    edp_exponent: float = 2.0          # paper: ED^2P is the sweet spot (Fig 6)
    max_delay_increase: float | None = None   # e.g. 0.10 -> at most +10% step time
    min_cap: float = 0.30              # never below the instability floor
    max_cap: float = 1.00
    scope: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.edp_exponent < 0:
            raise ValueError("edp_exponent must be >= 0")
        if not (0.0 < self.min_cap <= self.max_cap <= 1.0):
            raise ValueError("need 0 < min_cap <= max_cap <= 1")
        if self.max_delay_increase is not None and self.max_delay_increase < 0:
            raise ValueError("max_delay_increase must be >= 0")

    # -- A1-style (de)serialisation ----------------------------------------
    @classmethod
    def from_a1(cls, doc: Mapping[str, Any]) -> "QoSPolicy":
        return cls(
            policy_id=str(doc.get("policy_id", "unnamed")),
            edp_exponent=float(doc.get("edp_exponent", 2.0)),
            max_delay_increase=(None if doc.get("max_delay_increase") is None
                                else float(doc["max_delay_increase"])),
            min_cap=float(doc.get("min_cap", 0.30)),
            max_cap=float(doc.get("max_cap", 1.00)),
            scope=dict(doc.get("scope", {})),
        )

    def to_a1(self) -> dict[str, Any]:
        return {
            "policy_id": self.policy_id,
            "edp_exponent": self.edp_exponent,
            "max_delay_increase": self.max_delay_increase,
            "min_cap": self.min_cap,
            "max_cap": self.max_cap,
            "scope": dict(self.scope),
        }


ENERGY_LEAN = QoSPolicy(policy_id="energy-lean-ed1p", edp_exponent=1.0)
BALANCED = QoSPolicy(policy_id="balanced-ed2p", edp_exponent=2.0)
LATENCY_LEAN = QoSPolicy(policy_id="latency-lean-ed3p", edp_exponent=3.0)
