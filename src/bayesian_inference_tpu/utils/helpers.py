"""Logging / progress utilities (reference: helpers.py, common_base.py)."""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager


def setup_logging(level: int = logging.INFO) -> None:
    """Configure root logging with module names, preferring rich when available."""
    try:
        from rich.logging import RichHandler

        handler: logging.Handler = RichHandler(show_path=False)
        fmt = "%(name)s: %(message)s"
    except ImportError:
        handler = logging.StreamHandler(sys.stderr)
        fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
    logging.basicConfig(level=level, format=fmt, handlers=[handler], force=True)
    logging.captureWarnings(True)


@contextmanager
def stage_timer(name: str, logger: logging.Logger, record: dict[str, float] | None = None):
    """Log wall-clock for a pipeline stage (and store it in ``record[name]``)."""
    t0 = time.perf_counter()
    logger.info(f"[{name}] starting...")
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        if record is not None:
            record[name] = elapsed
        logger.info(f"[{name}] done in {elapsed:.2f}s")


def progress_iter(iterable, description: str, logger: logging.Logger | None = None, total: int | None = None):
    """Iterate with a rich progress bar (behavioral analog of the reference's
    progress_bar factory, helpers.py:66-82), falling back to periodic log
    lines on dumb terminals or when rich is unavailable.

    Usage: ``for x in progress_iter(items, "closure points"): ...``
    """
    items = list(iterable) if total is None else iterable
    n = total if total is not None else len(items)
    try:
        import rich.progress

        if not sys.stderr.isatty():
            raise ImportError  # live bars garble piped/log output
        progress = rich.progress.Progress(
            rich.progress.TextColumn("[progress.description]{task.description}"),
            rich.progress.BarColumn(bar_width=None),
            rich.progress.TaskProgressColumn(),
            rich.progress.TimeRemainingColumn(),
            rich.progress.MofNCompleteColumn(),
            refresh_per_second=1,
            expand=True,
        )

        def _run():
            with progress:
                task = progress.add_task(description, total=n)
                for x in items:
                    yield x
                    progress.advance(task)

        return _run()
    except ImportError:
        log = logger or logging.getLogger(__name__)

        def _run_logged():
            t0 = time.perf_counter()
            for i, x in enumerate(items):
                yield x
                done = i + 1
                if n and (done % max(1, n // 10) == 0 or done == n):
                    rate = (time.perf_counter() - t0) / done
                    log.info(f"{description}: {done}/{n} (~{rate * (n - done):.0f}s left)")

        return _run_logged()
