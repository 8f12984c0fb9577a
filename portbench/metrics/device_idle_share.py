"""device_idle_share: 1 - (union of the device's busy intervals) / the wall
of the device-only profiled stretch, %."""


def read(rec):
    d = rec.get("device")
    if not d or not d["window_s"] or not d["busy_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
