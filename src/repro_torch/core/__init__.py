"""Deferral, speculation and the execution channel of the serving stack."""
