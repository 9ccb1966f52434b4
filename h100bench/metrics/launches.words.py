"""The port's kernel launches a sort call: its own ``Kernel.launches``
counters, summed over every kernel, over the window's calls."""


def read(records):
    calls = records.get("calls")
    if not calls:
        return None
    return sum(records["launches"].values()) / calls
