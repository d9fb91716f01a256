"""Command-line tools of the port: ``trace_report`` and ``bench_compare``."""
