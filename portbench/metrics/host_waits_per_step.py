"""host_waits_per_step: the points where the host waited for the card in a
steady step (Reads, PyTorch's sync-debug mode)."""


def read(rec):
    r = rec.get("reads")
    if not r or not r["steps"]:
        return None
    return r["syncs"] / r["steps"]
