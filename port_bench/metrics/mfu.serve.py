"""mfu.serve (%, host_clock): model FLOPs served in the window over the window
and the fixed peak."""

from port_bench.readers import mfu


def read(record):
    return mfu(record, "serve")
