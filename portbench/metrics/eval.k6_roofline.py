"""K6 (window_attention, Swin's fused window attention) in eval: its calls' bound (bytes at 3.35 TB/s or products at the bf16 tensor-core peak) over the device time of the kernels inside their ranges; None where a range holds no device event."""

from portbench import readers


def read(run):
    r = (run.traced or {}).get("ranges", {}).get("portbench.k6")
    if not r or r.get("empty"):
        return None
    return readers.roofline_pct(run, "k6")
