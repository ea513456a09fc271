"""Adam's device time a step (ms): the device ops enqueued inside the
program's ``gslm.adam`` spans (``optim.adam_step``: the update of every
group), joined to their spans by ``port_bench.spans``, over the traced
steps."""

from port_bench.spans import span_ms


def read(tr, work):
    return span_ms(tr, "gslm.adam")
