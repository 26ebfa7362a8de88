"""Console-script entry points of the port (``pyproject.toml``
``[project.scripts]``, ``koemorph-torch-*``): each runs the ``main`` of
the module ``python -m koemorph_tpu_torch.<name>`` runs."""

from __future__ import annotations

import sys


def rt_main() -> int:
    from koemorph_tpu_torch.rt import main
    return main()


def rt_simplified_main() -> int:
    from koemorph_tpu_torch.rt_simplified import main
    return main()


def infer_main() -> int:
    from koemorph_tpu_torch.infer import main
    return main()


def export_main() -> int:
    from koemorph_tpu_torch.export_model import main
    return main()


def serve_main() -> int:
    from koemorph_tpu_torch.serve import main
    return main()


if __name__ == "__main__":  # pragma: no cover
    sys.exit(rt_main())
