"""Data pipeline: the deterministic synthetic stream, memmap token files
and the prefetch thread."""
