"""loader_wait_share.train: percent of the window the trainer's thread
waited on the loader's producer (the program's spans
koemorph.data.wait)."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.host_share(rec, "koemorph.data.wait",
                              "koemorph.train.scan")
