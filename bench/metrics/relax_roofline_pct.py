"""The fused relax kernel's share of its bytes roofline: the bytes its
calls' inputs need (``bench/tracing.py`` ``relax_bytes``) over the card's
published memory rate, against the calls' device time by CUDA events."""


def read(records):
    relax = records.get("relax")
    rate = records.get("hbm_bytes_per_s")
    if not relax or not rate or relax["device_s"] <= 0:
        return None
    return 100.0 * relax["bytes"] / rate / relax["device_s"]
