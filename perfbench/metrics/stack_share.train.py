"""stack_share.train: percent of the window spent padding and stacking each
epoch's batches (the program's spans koemorph.train.stack)."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.host_share(rec, "koemorph.train.stack",
                              "koemorph.train.scan")
