"""The A2C tick's model FLOPs (`flops.a2c_tick_flops`, from the
configuration's nets) over the traced ticks' wall time at the H100's FP32
peak, in %: the share of the whole step's time that the nets' arithmetic
would take at peak."""

from portbench.flops import a2c_tick_flops
from portbench.yardstick import PEAK_F32_FLOPS


def read(run):
    if run.trace is None or not run.traced_calls or run.trace.busy_s <= 0:
        return None
    return 100.0 * a2c_tick_flops(run.config) * run.traced_calls / (
        run.trace.window_s * PEAK_F32_FLOPS)
