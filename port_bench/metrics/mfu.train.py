"""mfu.train (%, host_clock): the training steps' model FLOPs (generator and
discriminators, forward and backward, from the shapes) over the window and the
fixed peak."""

from port_bench.readers import mfu


def read(record):
    return mfu(record, "train")
