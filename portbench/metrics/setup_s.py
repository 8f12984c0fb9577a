"""setup_s: seconds from the harness's start to the end of the warm-up
(loading, building, warming every shape the cell's traffic uses)."""


def read(rec):
    return rec.get("setup_s")
