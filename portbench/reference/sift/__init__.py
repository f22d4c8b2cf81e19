"""Frozen copy of the port's plain SIFT path (see ``pipeline.py``)."""
