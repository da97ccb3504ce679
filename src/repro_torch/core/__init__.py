"""repro.core — the paper's contribution: locality-queue task scheduling.

Faithful layer (drives the discrete-event simulator, reproduces Fig. 3/4):
  topology, tasks, placement, queues, scheduler, cost_model, simulator.

SPMD layer (the technique adapted to ahead-of-time TPU scheduling):
  assignment.
"""
from .assignment import Assignment, build_assignment, round_robin_assignment
from .cost_model import maxmin_rates, stream_sanity
from .placement import place
from .queues import LocalityQueues
from .scheduler import (
    OpenMPLocalityQueues,
    OpenMPTasking,
    Policy,
    StaticWorksharing,
    TBBLocalityQueues,
    TBBParallelFor,
    tbb_first_touch,
)
from .simulator import SimParams, SimResult, run_samples, simulate, summarize
from .tasks import PAPER_GRID, SMALL_GRID, Block, BlockGrid, block_bytes, bytes_per_site
from .topology import (
    ISTANBUL,
    NEHALEM_EP,
    NEHALEM_EX,
    TESTBED,
    LocalityDomain,
    MachineTopology,
    tpu_topology,
)

__all__ = [
    "Assignment", "build_assignment", "round_robin_assignment",
    "maxmin_rates", "stream_sanity", "place", "LocalityQueues",
    "OpenMPLocalityQueues", "OpenMPTasking", "Policy", "StaticWorksharing",
    "TBBLocalityQueues", "TBBParallelFor", "tbb_first_touch",
    "SimParams", "SimResult", "run_samples", "simulate", "summarize",
    "PAPER_GRID", "SMALL_GRID", "Block", "BlockGrid", "block_bytes",
    "bytes_per_site", "ISTANBUL", "NEHALEM_EP", "NEHALEM_EX", "TESTBED",
    "LocalityDomain", "MachineTopology", "tpu_topology",
]
