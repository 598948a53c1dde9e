"""The agent command line (``cli/main.py``)."""
