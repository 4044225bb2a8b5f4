"""Share of the port's counter-RNG calls that ran the threefry kernel
(`csrc/threefry.cu`): `rng_kernel_calls` over it plus `rng_plain_calls`,
the run's own counts as the cell's `Driver` keeps them (a graph replay adds
what its capture counted). Each `threefry2x32`, `fold_in`, `random_bits`
or `categorical` call of `rng.py` counts one, on the kernel or on its plain
int64 version. 1 where every call took the kernel; 0 from a program that
counts learner ticks but neither counter."""


def read(run):
    counts = getattr(run.driver, "counts", None)
    if not run.traced_calls or not counts or not counts.get("learn_ticks"):
        return None
    kernel = counts.get("rng_kernel_calls", 0)
    calls = kernel + counts.get("rng_plain_calls", 0)
    return kernel / calls if calls else 0.0
