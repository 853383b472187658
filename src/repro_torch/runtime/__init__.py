"""Runtime: content-addressed checkpoints and the dispatch straggler
monitor."""
