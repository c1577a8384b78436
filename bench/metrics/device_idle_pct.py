"""The device's idle share over a few steady queries under
``torch.profiler``: 100 minus the union of its operations' intervals as a
share of the profiled span."""


def read(records):
    prof = records.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
