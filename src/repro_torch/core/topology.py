"""Machine topologies: ccNUMA locality-domain layouts (paper Table 1) and TPU tiers.

The paper's test bed consists of three ccNUMA systems.  Each system is a set of
*locality domains* (LDs); every LD owns a memory bus with a STREAM-derived
bandwidth, cores are pinned to LDs, and nonlocal traffic crosses an inter-domain
link (HyperTransport / QPI) at reduced effective bandwidth.

The TPU topology expresses the same idea one tier up: a "locality domain" is a
pod (fast ICI inside, slow DCN between pods); chips play the role of cores.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class LocalityDomain:
    """One NUMA locality domain: a memory bus plus the cores attached to it."""

    ld_id: int
    cores: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MachineTopology:
    """A ccNUMA machine as a bandwidth graph.

    Bandwidths are GB/s and are calibrated from the paper's Table 1 STREAM-copy
    measurements.  ``local_bw`` is the per-LD memory-bus bandwidth (the "socket"
    STREAM number); ``remote_factor`` scales the bandwidth a core achieves on
    *nonlocal* accesses (the "NUMA effect" — strongest on Nehalem EP);
    ``core_bw`` bounds what a single core can draw (a single core cannot
    saturate its socket's bus).
    """

    name: str
    num_domains: int
    cores_per_domain: int
    local_bw: float           # GB/s, one LD's memory bus (Table 1 "socket")
    remote_factor: float      # effective-bandwidth factor for nonlocal access
    core_bw: float            # GB/s, max per-core achievable bandwidth
    nt_stores: bool           # nontemporal stores used (affects bytes/site)
    frequency_ghz: float = 0.0
    interconnect: str = ""

    # -- derived helpers ---------------------------------------------------
    @property
    def num_cores(self) -> int:
        return self.num_domains * self.cores_per_domain

    @property
    def full_bw(self) -> float:
        """Aggregate machine bandwidth with perfect locality (≈ Table 1 full)."""
        return self.num_domains * self.local_bw

    def domain_of_core(self, core: int) -> int:
        if not 0 <= core < self.num_cores:
            raise ValueError(f"core {core} out of range for {self.name}")
        return core // self.cores_per_domain

    def domains(self) -> Iterable[LocalityDomain]:
        for ld in range(self.num_domains):
            base = ld * self.cores_per_domain
            yield LocalityDomain(ld, tuple(range(base, base + self.cores_per_domain)))

    def ld_id_map(self) -> list[int]:
        """The paper's global ``ld_ID`` vector: thread/core index -> LD."""
        return [self.domain_of_core(c) for c in range(self.num_cores)]


# ---------------------------------------------------------------------------
# The paper's test bed (Table 1).  ``local_bw`` is the socket STREAM copy
# number; ``remote_factor`` is calibrated so that the three horizontal
# reference lines of Fig. 3 (serial-init / round-robin / first-touch) are
# reproduced by the cost model; see tests/test_simulator.py.
# ---------------------------------------------------------------------------

ISTANBUL = MachineTopology(
    name="istanbul",
    num_domains=4,
    cores_per_domain=6,
    local_bw=9.9,
    remote_factor=0.60,      # HT-mediated access, moderate NUMA penalty
    core_bw=4.5,
    nt_stores=True,
    frequency_ghz=2.41,
    interconnect="HyperTransport",
)

NEHALEM_EP = MachineTopology(
    name="nehalem_ep",
    num_domains=2,
    cores_per_domain=4,
    local_bw=18.9,
    remote_factor=0.40,      # strongest NUMA effect in the test bed (paper §1.4)
    core_bw=8.0,
    nt_stores=True,
    frequency_ghz=2.66,
    interconnect="QPI",
)

NEHALEM_EX = MachineTopology(
    name="nehalem_ex",
    num_domains=4,
    cores_per_domain=8,
    local_bw=8.15,           # EA system with half the memory boards (paper §1.3)
    remote_factor=0.70,      # fully-connected QPI
    core_bw=4.0,
    nt_stores=False,         # Table 1: EX ran without NT stores
    frequency_ghz=2.27,
    interconnect="QPI",
)

TESTBED: dict[str, MachineTopology] = {
    t.name: t for t in (ISTANBUL, NEHALEM_EP, NEHALEM_EX)
}


# ---------------------------------------------------------------------------
# TPU tier model: one "locality domain" = one pod.  Used by the SPMD schedule
# builder (assignment.py) and the serving router; bandwidths from the v5e
# hardware constants used throughout the roofline analysis.
# ---------------------------------------------------------------------------

def tpu_topology(num_pods: int, chips_per_pod: int = 256) -> MachineTopology:
    """A multi-pod TPU fleet viewed as a ccNUMA machine (pods = LDs).

    ``local_bw`` is per-chip HBM feed aggregated per pod is irrelevant here —
    what matters for scheduling is the *relative* cost of crossing the
    inter-pod tier, so we use ICI vs DCN effective bandwidths.
    """
    return MachineTopology(
        name=f"tpu_{num_pods}x{chips_per_pod}",
        num_domains=num_pods,
        cores_per_domain=chips_per_pod,
        local_bw=50.0 * chips_per_pod,   # ICI bisection proxy inside a pod
        remote_factor=0.05,              # DCN ≪ ICI: crossing pods is expensive
        core_bw=819.0,                   # HBM bandwidth per chip
        nt_stores=True,
        interconnect="ICI/DCN",
    )
