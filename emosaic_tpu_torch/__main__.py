"""`python -m emosaic_tpu_torch` — the CLI entry point."""

import sys

from emosaic_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
