"""Entry drivers: each builds the program for one kind of configuration and
steps it a decision at a time. A configuration names its driver."""

from __future__ import annotations


class Base:
    """What the harness asks of a driver (see ``core.harness``).

    ``KERNELS`` maps a kernel's short name to a part of its name in the
    device trace; ``DEVICE_SPANS`` names the spans whose device time the
    traced run reads. ``failed`` counts decisions of the window that came
    back as errors."""

    KERNELS = {"assign_count": "assign_count_kernel", "aoi": "aoi_kernel"}
    DEVICE_SPANS: tuple = ()

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = device
        self.failed = 0

    def sync(self) -> None:
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def memory_peak_bytes(self) -> int:
        import torch

        if torch.device(self.device).type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated())

    def device_name(self) -> str:
        import torch

        if torch.device(self.device).type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name()

    def free_device(self) -> None:
        import gc

        import torch

        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def kernel_shapes(self) -> dict:
        """{kernel: (rows, cols, grid cols, grid rows)} of the launches a
        decision makes: K1 over every entity slot and cell, K2 over every
        query row and cell."""
        grid = self.config["grid"]
        cells = int(grid["cols"]) * int(grid["rows"])
        return {"assign_count": (int(self.config["entity_capacity"]), cells),
                "aoi": (int(self.config["query_capacity"]), int(grid["cols"]),
                        int(grid["rows"]))}

    def info(self) -> list[str]:
        return []
