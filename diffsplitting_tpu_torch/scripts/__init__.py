"""Command-line scripts of the port (evaluation, the synthetic quality run)."""
