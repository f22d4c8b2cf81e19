"""The benchmark of the PyTorch and CUDA port (``niftymatch_torch``).

``run.py`` runs one cell and prints its result line; ``control.py`` reads
the numbers a cell's comparison limits are set from.  See ``harness.py``
for how a cell is found and run, and ``PERF.md`` at the repository's root
for the cells, metrics and limits.
"""
