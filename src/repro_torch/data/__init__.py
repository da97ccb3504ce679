"""The synthetic corpus and its locality-scheduled loader: a copy of
``repro.data.pipeline`` (numpy only), importing the port's own
``core.assignment``."""
