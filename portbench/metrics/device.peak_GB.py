"""device.peak_GB: torch.cuda.max_memory_allocated() over the window
(reset at its start), in 10^9 bytes."""


def read(rec):
    return rec.peak_bytes / 1e9 if rec.peak_bytes else None
