"""Ops: resize and the three kernel-backed ops (K1 ms-deform forward, K3
mask render, K4 upsample+binarize), each with its plain twin."""
