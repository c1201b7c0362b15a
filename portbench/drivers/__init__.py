"""One module per entry of the port that a window drives; see `portbench/harness.py`."""
