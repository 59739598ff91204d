"""``repro_torch.analysis``: static checks over the port's kernel registry
and source (twin of ``repro.analysis``).

Two engines, one finding model:

  * ``repro_torch.analysis.contracts``: the contract sweep. It walks every
    registered ``(op, mode)`` pair of ``repro_torch.ops`` over an
    edge-shape corpus on fake CPU tensors (``FakeTensorMode``: no FLOP, no
    launch; the cells whose plain versions read operand values run on
    seeded CPU operands) and checks dispatch totality, no silent
    downgrades, format and dtype preservation, metadata propagation, grad
    coverage, the block contract and each family's shared memory.
  * ``repro_torch.analysis.lint``: AST and regex rules over the port's
    source (registry bypass, host syncs in per-tick code, bare Heavisides,
    hard-coded CPU devices, mutable defaults, the legacy-surface guards),
    with per-line ``# neurallint: disable=RULE`` suppressions.

``tools/torch_neurallint.py`` is the command line over both.
"""
from .findings import Finding, RULES, junit_xml, render
from .abstract import AbstractEvalError, abstract_eval, spike_aval
from .contracts import ContractReport, verify_contracts
from .lint import lint_paths, lint_source

__all__ = [
    "Finding", "RULES", "junit_xml", "render",
    "AbstractEvalError", "abstract_eval", "spike_aval",
    "ContractReport", "verify_contracts",
    "lint_paths", "lint_source",
]
