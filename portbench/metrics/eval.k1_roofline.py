"""K1 (ms_deform_attn) in eval: its calls' bound over the device time of the kernels inside their ranges."""

from portbench import readers


def read(run):
    return readers.roofline_pct(run, "k1")
