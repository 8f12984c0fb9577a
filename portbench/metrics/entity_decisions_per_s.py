"""entity_decisions_per_s: the live entities covered by every decision
completed in the window, over the window's seconds (the north star's "AOI
updates/s")."""


def read(rec):
    if not rec.get("live") or not rec.get("window_s"):
        return None
    return float(sum(rec["live"])) / rec["window_s"]
