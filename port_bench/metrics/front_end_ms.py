"""The front end's device time a step (ms): the device ops enqueued inside
the program's ``gslm.front_end`` spans (``rasterize_cuda.tile_records``:
the cell masks, the duplication, the sort and the record gather), joined
to their spans by ``port_bench.spans``, over the traced steps."""

from port_bench.spans import span_ms


def read(tr, work):
    return span_ms(tr, "gslm.front_end")
