"""The finding model shared by both neurallint engines of the port, and the
rule catalog (twin of ``repro.analysis.findings``: the same 14 rule ids;
where a rule's subject differs in the port, its text says what it polices
here)."""
from __future__ import annotations

import dataclasses
from xml.sax.saxutils import escape

#: rule id -> one-line description. Both engines draw their ids from this
#: table; ``tools/torch_neurallint.py --rules`` prints it.
RULES = {
    # -- engine 1: the contract sweep (repro_torch.analysis.contracts) --
    "NL-DISPATCH-TOTALITY": (
        "every advertised (op, policy) point resolves in the registry: no "
        "NotImplementedError at dispatch time"),
    "NL-SILENT-DOWNGRADE": (
        "a dispatch under policy P resolves only P's kernel axis: a "
        "'fused' request recording a 'reference' lookup (or the other way "
        "round) is a silent downgrade"),
    "NL-FORMAT-PRESERVE": (
        "spike outputs leave in the policy's format with the contracted "
        "dtype (int8 dense / int32 words packed; dense f32 under +grad)"),
    "NL-META-PROP": (
        "every packed output carries a vld_cnt block map whose grid is "
        "shape-consistent with the payload"),
    "NL-GRAD-COVERAGE": (
        "every op of a grad-declaring family registers both "
        "'reference+grad' and 'fused+grad' implementations"),
    "NL-BLOCK-CONTRACT": (
        "the packed block-shape contract is satisfiable on the corpus and "
        "its runtime guard rejects mismatched tilings"),
    "NL-VMEM-BUDGET": (
        "each family's shared-memory model, read off its csrc/ tiles, fits "
        "the shared memory per block of the H100 "
        "(launch.roofline.SMEM_BYTES_PER_BLOCK)"),
    # -- engine 2: the source lint (repro_torch.analysis.lint) --
    "NL-REGISTRY-BYPASS": (
        "repro_torch.kernels.* imported outside repro_torch.ops / "
        "repro_torch.kernels / repro_torch.analysis: call sites go through "
        "the policy registry"),
    "NL-HOST-SYNC": (
        ".item()/.tolist()/.cpu()/float()/int()/np.asarray()/np.array()/"
        "torch.cuda.synchronize() inside a torch.compile-decorated function "
        "or an engine tick / route path: a hidden device-to-host sync"),
    "NL-BARE-HEAVISIDE": (
        "a Heaviside spelled as a comparison cast ((a >= b).to(...) / "
        ".float()) on the differentiable surface: use core.surrogate.spike "
        "so that the registered pseudo-derivative flows"),
    "NL-INTERPRET-HARDCODE": (
        "a hard-coded device='cpu' or torch.device('cpu') default in "
        "non-test code: the device is the caller's or resolve_device's"),
    "NL-MUTABLE-DEFAULT": (
        "mutable default (list/dict/set literal or constructor) in a "
        "function signature or dataclass field: one instance shared by "
        "every call"),
    "NL-LEGACY-FLAGS": (
        "deleted pre-policy flag kwargs "
        "(use_event_kernels= / spike_format= / pack_out=)"  # neurallint: disable=NL-LEGACY-FLAGS
        " reappearing"),
    "NL-LEGACY-FORKS": (
        "deleted snn_cnn forward forks "
        "(_apply_fused_event / _apply_fused_reference / "  # neurallint: disable=NL-LEGACY-FORKS
        "snn_cnn.apply(_fused)) reappearing"),  # neurallint: disable=NL-LEGACY-FORKS
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: a catalogued rule, a location, and the message."""
    rule: str
    path: str                      # repo-relative, or "<registry>" for a
                                   # contract finding with no source line
    line: int
    message: str

    def __post_init__(self):
        assert self.rule in RULES, f"unknown rule id {self.rule!r}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def render(findings: list) -> str:
    """Human-readable report."""
    if not findings:
        return "neurallint: clean"
    lines = [f"neurallint: {len(findings)} finding(s)"]
    lines += [str(f) for f in findings]
    return "\n".join(lines)


def junit_xml(findings: list, *, checked: int, suite: str = "neurallint"
              ) -> str:
    """Findings as a JUnit report: one testcase per rule, a rule with
    findings failing with every location in the failure's body."""
    by_rule: dict[str, list] = {r: [] for r in RULES}
    for f in findings:
        by_rule[f.rule].append(f)
    cases = []
    for rule in RULES:
        hits = by_rule[rule]
        if hits:
            body = escape("\n".join(str(f) for f in hits))
            cases.append(
                f'  <testcase classname="{suite}" name="{rule}">\n'
                f'    <failure message="{len(hits)} finding(s)">'
                f'{body}</failure>\n  </testcase>')
        else:
            cases.append(f'  <testcase classname="{suite}" name="{rule}"/>')
    return (f'<?xml version="1.0" encoding="utf-8"?>\n'
            f'<testsuite name="{suite}" tests="{len(RULES)}" '
            f'failures="{sum(1 for r in by_rule.values() if r)}" '
            f'checked="{checked}">\n' + "\n".join(cases) + "\n</testsuite>\n")
