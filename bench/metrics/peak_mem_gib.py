"""The device's peak allocated memory in GiB
(``torch.cuda.max_memory_allocated``), read once the window has closed
and before the reference runs; the count restarts after the benchmark's
own input generation, and the check keeps its sample in host memory, so
it is the program's state and its queries alone."""


def read(records):
    peak = records["memory_peak_bytes"]
    return peak / 2**30 if peak else None
