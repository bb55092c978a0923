"""The general loops of the traffic mixes: ``loops/<kind>.py`` runs
every mix whose data file (``traffic/<name>.json``) names that ``kind``.
A loop builds the port's system under test from the cell's
configuration, warms it up, measures for ``--seconds``, frees it and
checks what it produced against the plain reference
(``leafbench/check.py``)."""
