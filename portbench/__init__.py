"""The port's benchmark: cells of configurations and traffic mixes, run by
``python3 -m portbench.run``; see ``bench.py``."""
