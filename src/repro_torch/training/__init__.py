"""Serving step functions (prefill, batched prefill, fused k-step decode)."""
