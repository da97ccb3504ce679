"""Distribution for the port: ``sharding`` (logical-axis rules over a
``DeviceMesh``, DTensor placements), ``collectives`` (compressed all-reduce,
LSE combine, halo exchange on ``torch.distributed``), ``pipeline`` (the
GPipe stage loop) and ``fault`` (a copy of ``repro.distributed.fault``,
numpy only, importing the port's own ``core.assignment``)."""
