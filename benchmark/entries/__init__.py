"""The drivers of the traffic mixes: one module per ``entry`` that a
traffic file names (see ``benchmark/harness.py`` for what each defines)."""
