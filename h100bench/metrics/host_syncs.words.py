"""The port's host syncs a sort call: its own counter ``host_syncs``
(``repro_torch.runtime.trace``: readbacks, boolean-mask indexes of device
tensors, blocking uploads), recorded over the traced calls, over those
calls. ``None`` where nothing was traced or the port records no spans."""


def read(records):
    tr = records.get("trace")
    calls = tr["counts"].get("calls") if tr else None
    if not calls:
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    if not trace.spans():
        return None
    return trace.counters().get("host_syncs", 0) / calls
