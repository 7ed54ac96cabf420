"""Model FLOPs of the window's training steps (three forwards per image) per second, over the H100's dense bf16 peak."""

from portbench import readers


def read(run):
    return readers.mfu_pct(run, "train_flops_per_image", "images")
