"""host_ms.serve (ms, program_span): the fleet's mean host time a dispatch, from
the call to its ``run`` until it returns, before the synchronize."""

from port_bench.readers import host_ms


def read(record):
    return host_ms(record, "serve")
