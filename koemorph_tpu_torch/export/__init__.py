"""Export: one frame function through ``torch.export`` to a ``.pt2``
program, with a numerical parity gate and a latency harness."""

from koemorph_tpu_torch.export.exporter import (
    ExportReport,
    FrameFunction,
    benchmark_fn,
    benchmark_rounds,
    export_program,
    load_program,
    verify_export,
)

__all__ = ["ExportReport", "FrameFunction", "export_program",
           "load_program", "verify_export", "benchmark_fn",
           "benchmark_rounds"]
