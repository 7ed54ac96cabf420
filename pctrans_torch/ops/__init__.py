"""Ops: resize, point sampling, the host LAP, and the kernel-backed ops
(K1/K2 ms-deform forward and backward, K3 mask render, K4
upsample+binarize), each with its plain twin."""
