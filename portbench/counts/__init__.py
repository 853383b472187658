"""The benchmark's frozen arithmetic: the card's peaks, each kernel's least
work from its inputs, and a step's model FLOPs."""
