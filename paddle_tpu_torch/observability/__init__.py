"""Observability for the port: the metrics registry the decode modules
record into (``metrics.py``)."""
