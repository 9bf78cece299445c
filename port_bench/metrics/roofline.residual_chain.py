"""roofline.residual_chain (%, device_trace): the residual chain kernel's
launches against their bound at the fixed peaks (port_bench/flops.py)."""

from port_bench.readers import roofline


def read(record):
    return roofline(record, "serve", "residual_chain")
