"""idle_share.serve (%, device_trace): the share of the traced serving window in
which no device operation ran."""

from port_bench.readers import idle_share


def read(record):
    return idle_share(record, "serve")
