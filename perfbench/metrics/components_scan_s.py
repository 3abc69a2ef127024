"""components_scan_s: seconds per solve of the core's component search
outside its exact solves (the program's span ``components.scan``, from the
core's clock: ``solve_small_components`` less ``medium_solve``)."""

from perfbench.yardstick.core_profile import span_seconds


def read(ctx):
    return span_seconds(ctx, ["components.scan"])
