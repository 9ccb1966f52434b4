"""The port's host syncs a wave of serving: its own counter ``host_syncs``
(``repro_torch.runtime.trace``: the admission's uploads and readback, each
batch's uploads and a readback a generated token), recorded over the traced
waves, over those waves. ``None`` where nothing was traced or the port
records no spans."""


def read(records):
    tr = records.get("trace")
    waves = tr["counts"].get("waves") if tr else None
    if not waves:
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    if not trace.spans():
        return None
    return trace.counters().get("host_syncs", 0) / waves
