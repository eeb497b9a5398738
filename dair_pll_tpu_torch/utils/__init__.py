"""Host-side utilities: storage layout, checkpointing, logging and
profiling."""
