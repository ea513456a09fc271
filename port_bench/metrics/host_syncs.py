"""Host syncs a step: the CUDA runtime calls in the traced window that
block the host until the device has caught up (``port_bench.spans.SYNCS``:
stream, device and event synchronisation, blocking copies), over the
traced steps. Each drains the launch queue, so the host's launch rate then
paces the device."""

from port_bench.spans import host_syncs


def read(tr, work):
    if not tr.device:
        return None
    return host_syncs(tr) / tr.steps
