"""Model FLOPs of the forwards the window ran per second, over the H100's dense bf16 peak."""

from portbench import readers


def read(run):
    return readers.mfu_pct(run, "eval_flops_per_forward", "forwards")
