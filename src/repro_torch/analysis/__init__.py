"""repro_torch.analysis — static analysis for the port (counterpart of
``repro.analysis``).

Three checkers over a shared AST framework (see ``framework``):

* ``units``            dimensional analysis from the unit-suffix convention
* ``torch-hot-path``   host syncs on the port's torch hot paths
* ``scheduler-purity`` no self-mutation in Scheduler.choose/dispatch

``findings``, ``framework``, ``baseline``, ``cli``, ``units`` and
``purity`` are the JAX package's modules with their imports renamed;
``framework.default_checkers`` lists ``torch_hotpath`` in the place of
``jax_hotpath``. Run with ``python -m repro_torch.analysis``.
"""
from repro_torch.analysis.findings import ERROR, WARNING, Finding, RawFinding
from repro_torch.analysis.framework import (analyze_paths, analyze_source,
                                            default_checkers)

__all__ = ["ERROR", "WARNING", "Finding", "RawFinding", "analyze_paths",
           "analyze_source", "default_checkers", "main"]


def main(argv=None):
    from repro_torch.analysis.cli import main as _main
    return _main(argv)
