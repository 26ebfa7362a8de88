"""The drivers of the traffic mixes: ``perfbench/drivers/<driver>.py`` is
the module a traffic file's ``driver`` names
(:func:`perfbench.harness.spec.driver`).

Importing the package switches the program's span registry on when the
process's command line asks for a traced run (``--trace 1``), so that it
is on before a driver builds the program's engines and captures their
CUDA graphs (:func:`perfbench.harness.program.enable_for_traced_run`). A
run with ``--trace 0`` never switches it on; a program without the
registry runs as it is, and the metrics that read it read nothing.
"""

from perfbench.harness import program

program.enable_for_traced_run()
