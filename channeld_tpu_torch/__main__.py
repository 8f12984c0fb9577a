"""Run the channeld-tpu gateway on torch: ``python -m channeld_tpu_torch [flags]``.

Flag surface matches the reference (ref: cmd/main.go, settings.go:144-235)
and the JAX package's gateway, plus ``-spatial-device`` (the spatial
engine runs on ``cuda`` unless it is ``cpu``).
"""

import asyncio
import sys


def main() -> None:
    from .core.server import run_server

    try:
        asyncio.run(run_server(sys.argv[1:]))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
