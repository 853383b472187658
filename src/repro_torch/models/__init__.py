"""Model config, layers and the dense stage-structured model."""
