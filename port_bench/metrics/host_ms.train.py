"""host_ms.train (ms, program_span): the mean host time of the training step's
call, from the call until it returns, before the synchronize."""

from port_bench.readers import host_ms


def read(record):
    return host_ms(record, "train")
