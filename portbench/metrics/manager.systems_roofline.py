"""The systems step's bound (bytes or FP32 operations of the traced steps)
over its kernel's mean traced device time, in %."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "step_systems_kernel", "systems_bound_s")
