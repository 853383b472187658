"""Model config, layers, the Mamba2 and xLSTM blocks, and the
stage-structured model (dense, hybrid and ssm stages)."""
