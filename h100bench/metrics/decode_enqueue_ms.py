"""Median host ms of a decode step's enqueue: the port's ``engine.decode``
spans (``repro_torch.runtime.trace``, inside ``Engine._decode``, so without
the ``torch.cuda.synchronize()`` the benchmark's wrapper adds after it) over
the traced waves. Against ``decode_ms``, the same step synchronised, it
splits a step into the host's launches and the wait for the device. ``None``
where nothing was traced or the port records no such span."""

import statistics


def read(records):
    if not records.get("trace"):
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    steps = [1e-6 * (s["end_ns"] - s["start_ns"]) for s in trace.spans()
             if s["name"] == "engine.decode" and s["end_ns"] is not None]
    return statistics.median(steps) if steps else None
