"""upload_share.train: percent of the window spent copying each epoch's
stack to the device (the program's spans koemorph.train.upload)."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.host_share(rec, "koemorph.train.upload",
                              "koemorph.train.scan")
