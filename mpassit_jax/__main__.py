"""CLI entry point: ``python -m mpassit_jax <namelist>`` or the ``mpassit``
console script (defaults to ./fort.41 like the reference driver,
mpassit.F90:52-65)."""

import sys

from .run.pipeline import main

if __name__ == "__main__":
    sys.exit(main())
