"""Observability of the port: the hardware peak table (``peaks``), the
per-op cost model of the backend surface (``txn_cost``) and the
Chrome-trace exporter of the per-wave timeline (``trace``), each the twin
of the JAX package's ``analysis/<name>.py``."""
