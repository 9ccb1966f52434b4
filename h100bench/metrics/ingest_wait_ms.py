"""Host ms a chunked sort call spends waiting for the prefetch worker's
staging of its next chunk: the port's ``ingest.wait`` spans
(``repro_torch.runtime.trace``, around each ``fut.result()``) summed over
the traced calls, over those calls. ``None`` where nothing was traced or
the port records no such span."""


def read(records):
    tr = records.get("trace")
    calls = tr["counts"].get("calls") if tr else None
    if not calls:
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    waits = [s["end_ns"] - s["start_ns"] for s in trace.spans()
             if s["name"] == "ingest.wait" and s["end_ns"] is not None]
    if not waits:
        return None
    return 1e-6 * sum(waits) / calls
