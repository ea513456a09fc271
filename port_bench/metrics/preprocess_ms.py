"""The preprocess's device time a step (ms): the device ops enqueued inside
the program's ``gslm.preprocess`` spans (``renderer._pre``: projection,
covariance and SH, forward), joined to their spans by
``port_bench.spans``, over the traced steps."""

from port_bench.spans import span_ms


def read(tr, work):
    return span_ms(tr, "gslm.preprocess")
