"""Kernel launches the host makes a training step: the CUDA runtime and
driver launch calls in the window's trace over the steps the window
trained."""

from xvbench import readers

UNIT = "launches"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def read(record):
    if not readers.traced(record, "train") or not record["steps"]:
        return None
    n = sum(record["trace"]["runtime"][name] for name in LAUNCH_CALLS)
    return n / record["steps"] if n else None
