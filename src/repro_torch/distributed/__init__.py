"""Fault handling for training: a copy of ``repro.distributed.fault``
(numpy only), importing the port's own ``core.assignment``.  Sharding,
collectives and the pipeline schedule wait for a mesh (ROADMAP E3)."""
