"""Cells whose files are in ``benchmark/`` but which ``BENCHMARK.json``
leaves out until the program runs them correctly: ``entries.json`` holds
their entries, the configurations lie beside it, ``cells.py`` runs them."""
