"""CPU tests of the benchmark (``python -m pytest bench/tests``); those
marked ``cuda`` run on the card."""
