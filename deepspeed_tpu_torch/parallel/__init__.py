"""Parallel layouts: the rank topology (``topology.py``)."""
