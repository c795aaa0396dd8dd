"""Kernels: K2, the range probe (`ops/cuda_probe.py`, `csrc/range_probe.cu`):
the least time the traced stretch's probes could take on the card
(`kernelwork`: each key read once, each (start, count) pair written once,
over 3.35 TB/s or 67 T/s compares) over the device time of the kernels the
profiler names, in percent."""

from lakebench import devtrace, kernelwork, peaks

KERNELS = ("windowed_probe",)


def read(run):
    if run.stretch is None:
        return None
    t = devtrace.kernel_seconds(run.stretch, KERNELS)
    nbytes, ops = kernelwork.stretch_work(run, "K2")
    if t <= 0 or nbytes <= 0:
        return None
    return peaks.roofline_share(peaks.bound_seconds(nbytes, ops)[0], t)
