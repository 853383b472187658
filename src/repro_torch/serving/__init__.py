"""Serving stack: scheduler, stream executor, commit frontier, engine."""
