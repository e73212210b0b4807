"""The entries a cell drives: ``endpoint`` (HTTP) and ``generate`` (Python)."""
