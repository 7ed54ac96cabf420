"""K3 (dynamic_mask_render) in eval: its calls' bound (3xTF32 on the tensor cores) over the device time of the kernels inside their ranges."""

from portbench import readers


def read(run):
    return readers.roofline_pct(run, "k3")
