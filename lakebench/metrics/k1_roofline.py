"""Kernels: K1, the in-bucket sort (`ops/cuda_sort.py`, `csrc/bucket_sort.cu`):
the least time the traced stretch's sorts could take on the card
(`kernelwork`: each key read once, each sorted key and slot written once,
over 3.35 TB/s or 67 T/s compares) over the device time of the kernels the
profiler names, in percent."""

from lakebench import devtrace, kernelwork, peaks

KERNELS = ("sort_tiles", "merge_runs")


def read(run):
    if run.stretch is None:
        return None
    t = devtrace.kernel_seconds(run.stretch, KERNELS)
    nbytes, ops = kernelwork.stretch_work(run, "K1")
    if t <= 0 or nbytes <= 0:
        return None
    return peaks.roofline_share(peaks.bound_seconds(nbytes, ops)[0], t)
