"""% of the traced window with no operation on the device."""

from portbench.readers import device_idle


def read(run):
    return device_idle(run)
