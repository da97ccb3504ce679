"""Training: AdamW (``optimizer``), the train step (``train_step``) and the
restartable loop (``loop``), ported from ``repro.train``."""
