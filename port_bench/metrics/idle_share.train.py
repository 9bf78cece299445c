"""idle_share.train (%, device_trace): the share of the traced training window
in which no device operation ran."""

from port_bench.readers import idle_share


def read(record):
    return idle_share(record, "train")
