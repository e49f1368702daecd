"""Cluster launchers (``tracker/local.py``: one host)."""
