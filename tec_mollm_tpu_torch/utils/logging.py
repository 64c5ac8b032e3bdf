"""Root logging, configured once by the entry points."""

from __future__ import annotations

import logging
import sys


def setup_logging(level: int = logging.INFO, process_index: int = 0) -> None:
    """Configure root logging; processes other than rank 0 log at WARNING."""
    logging.basicConfig(
        level=level if process_index == 0 else max(level, logging.WARNING),
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        stream=sys.stderr,
        force=True,
    )
