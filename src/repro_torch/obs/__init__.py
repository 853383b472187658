"""Tracing and metrics used by the serving stack."""
