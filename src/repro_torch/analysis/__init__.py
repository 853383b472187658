"""Per-rank cost and an H100 roofline of the port's steps.

``cost`` counts a step's flops, HBM bytes and collective wire bytes, from
the ops it dispatches or from its exported graph (the counterpart of the
reference's ``analysis/hlo.py``); ``roofline`` turns a cost into compute,
memory and collective times at the H100's rates.  Importing this package
starts no process group and loads nothing of ``torch.testing``.
"""
