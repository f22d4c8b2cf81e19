"""Plain per-stage SIFT operations: frozen copies of the port's ``ops/``."""
