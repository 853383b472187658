"""Tracing, metrics and the report schemas (``schema.py``) used by the
serving stack and the lifecycle API."""
