"""The device memory peak of the run up to the window's close
(`torch.cuda.max_memory_allocated`), in GiB, the fullest card's."""

COMBINE = "max"


def read(r):
    return r.memory_peak_bytes / 2**30 if r.memory_peak_bytes else None
