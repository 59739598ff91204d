"""The kernel cost model of the sparsity-adaptive autotuner, and the
roofline report over dry-run cells (twin of ``repro.launch.roofline``).

``spike_matmul_traffic``, ``spike_matmul_grad_traffic``, ``qk_chain_traffic``
and ``kernel_time_s`` carry the reference's traffic arithmetic unchanged:
bytes and operations of one accumulation sweep per byte-skip strategy,
counted as a Pallas grid streams its tiles. Only the constants are the
port's: a ``CostModel`` describes the port's kernels on one card, and every
function takes one (``H100`` by default), so the same arithmetic can be
priced with other figures.

The report half (``analyze_cell``, ``suggestion``, ``load``, ``markdown``,
``main``) reads the cells ``launch.dryrun`` writes, with the reference's
logic unchanged. A ``Chip`` prices it, frozen as ``CostModel`` is: ``H100``
for the port (the H100 SXM's data-sheet rates), or any other. All inputs
are per device, so

  compute_term    = flops_per_dev / chip.peak_flops             [s]
  memory_term     = bytes_per_dev / chip.hbm_bw                 [s]
  collective_term = wire_bytes_per_dev / chip.link_bw           [s]

``bound`` is the largest term; ``useful_ratio`` = MODEL_FLOPS / (chips *
flops_per_dev) (the share of the traced math that is the model's: catches
remat and redundancy) and ``roofline_fraction`` = (MODEL_FLOPS / chips /
peak) / max(terms). A cell whose trace waits for tensor parallelism
(ROADMAP queue 1 item 6) shows its argument bytes only; its terms read
"not ported".

Usage:
  python -m repro_torch.launch.roofline [--dir build/dryrun] [--mesh single]
         [--tag TAG] [--json out.json] [--suggest]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


@dataclasses.dataclass(frozen=True)
class Chip:
    """The per-device rates the report prices a cell with.

    peak_flops   — dense operations per second
    hbm_bw       — device memory bytes per second
    link_bw      — interconnect bytes per second, each direction
    hbm_per_chip — device memory bytes (the "fits" column)
    """
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_per_chip: float


#: the NVIDIA H100 SXM 80GB by its data sheet: dense bf16 tensor-core rate
#: (the rate the kernel rows' bounds in PERF.md use), HBM3 rate, NVLink 4
#: (900 GB/s both ways together), device memory
H100_SXM = Chip("H100 SXM", peak_flops=989.4e12, hbm_bw=3.35e12,
                link_bw=450e9, hbm_per_chip=80e9)

#: shared memory one block (CTA) may take on an H100: 227 KiB, the limit
#: every ``kernels.contract`` shared-memory model is checked against
SMEM_BYTES_PER_BLOCK = 232448


@dataclasses.dataclass(frozen=True)
class CostModel:
    """The constants the cost model prices with.

    peak_flops        — operations per second of a kernel's full tiles
    hbm_bw            — device memory bytes per second
    launch_overhead_s — fixed cost of one kernel launch
    gating_overhead_s — the gated routes' extra metadata pass
                        (``compact_kmap`` of the vld map)
    subtile_eff       — rate of a stripe-skipped (``"two_level"``) step as
                        a fraction of ``peak_flops``
    """
    peak_flops: float
    hbm_bw: float
    launch_overhead_s: float
    gating_overhead_s: float
    subtile_eff: float


# The port's kernels on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
# (nvidia-smi), each value measured by chip_smoke.py's "[constants]" phase
# (``phase_constants``), which prints them again on every run:
H100 = CostModel(
    # the f32 FMA rate of the 8x8 register-tile kernels (no tensor cores):
    # the dense-skip spike matmul on an all-active 4096 x 4608 x 512
    # operand, 2 M K N operations over its time
    peak_flops=37.031e12,      # 0.5219 ms
    # device-to-device copy of 1 GiB, bytes read and written over its time
    hbm_bw=3.032e12,           # 0.7082 ms
    # one back-to-back launch of the dense-skip spike matmul on a single
    # silent 128 x 128 x 128 tile, the wrapper's ctypes call included
    launch_overhead_s=24.661e-6,
    # compact_kmap of resblock 1's [2048, 9] vld map on the card
    gating_overhead_s=206.847e-6,
    # the two-level route at half its stripes clear against the gated
    # route on the same operand: (time gated / 2) / time two-level
    subtile_eff=0.9523,        # 0.4558 / 2 / 0.2393 ms
)


def spike_matmul_traffic(m: int, k: int, n: int, *,
                         block_m: int = 128, block_n: int = 128,
                         block_k: int = 128, active_frac: float = 1.0,
                         occ_frac: float = 1.0, packed: bool = False,
                         skip: str = "dense", kernels: str = "fused",
                         costs: CostModel = H100) -> dict:
    """Streaming traffic and operation model of one spike matmul / fused_pe
    accumulation sweep, per byte-skip strategy (the reference's arithmetic).

    Bytes are counted as the kernel streams them, one x and one w tile per
    visited grid step, not as unique tensor bytes. ``active_frac`` is the
    fraction of non-silent (block_m x block_k) tiles; ``occ_frac`` the
    fraction of occupied 32-column stripes within active tiles. Returns
    {"hbm_bytes", "flops", "mxu_eff", "overhead_s"}; feed it to
    ``kernel_time_s``."""
    gm, gn, gk = -(-m // block_m), -(-n // block_n), -(-k // block_k)
    x_tile = block_m * block_k // 8 if packed else block_m * block_k
    w_tile = block_k * block_n * 4
    out_bytes = gm * gn * block_m * block_n * 4
    if kernels == "reference":
        # one dense product: unique bytes, full operations, no launch
        # overhead modeled (and no block skip)
        x_bytes = gm * gk * (block_m * block_k // 8 if packed
                             else block_m * block_k)
        return {"hbm_bytes": x_bytes + gk * gn * w_tile + out_bytes,
                "flops": 2.0 * m * n * k, "mxu_eff": 1.0,
                "overhead_s": 0.0}
    meta_bytes = 4 * gm * gk                      # vld map
    if skip == "dense":
        steps = gm * gn * gk                      # every tile streams
        flops = 2.0 * m * n * k * active_frac     # the skip saves operations
        eff = 1.0
        overhead = costs.launch_overhead_s
    else:
        # at least one tile per (m-row, n-block): a fully silent row still
        # fetches its revisit target once; continuous in active_frac
        steps = gm * gn * max(active_frac * gk, 1.0)
        flops = 2.0 * m * n * k * active_frac
        eff = 1.0
        overhead = costs.launch_overhead_s + costs.gating_overhead_s
        meta_bytes += 4 * gm * (gk + 1)           # kmap + nact
        if skip == "two_level":
            flops = 2.0 * m * n * k * active_frac * occ_frac
            eff = costs.subtile_eff
            meta_bytes += 4 * gm * gk             # occ bitmap
    return {"hbm_bytes": steps * (x_tile + w_tile) + out_bytes + meta_bytes,
            "flops": flops, "mxu_eff": eff, "overhead_s": overhead}


def spike_matmul_grad_traffic(m: int, k: int, n: int, *,
                              block_m: int = 128, block_n: int = 128,
                              block_k: int = 128, active_frac: float = 1.0,
                              occ_frac: float = 1.0, packed: bool = False,
                              skip: str = "dense", kernels: str = "fused",
                              costs: CostModel = H100) -> dict:
    """Streaming traffic and operation model of the backward of one spike
    matmul / fused_pe sweep (the reference's arithmetic): dx = (g ⊙ surr')
    @ wᵀ, dense, at unique tensor bytes plus one read of the cached
    membrane current; and dw = xᵀ @ dv, event-skipped on the forward
    operand's vld map (``skip`` gates this sweep only), priced streaming.
    ``kernels="reference"`` prices the autodiff backward: unique-byte
    dense sweeps plus the surrogate recompute's extra read of x and w.
    Returns the ``spike_matmul_traffic`` keys plus the per-sweep byte
    splits."""
    gm, gn, gk = -(-m // block_m), -(-n // block_n), -(-k // block_k)
    g_tile = block_m * block_n * 4
    w_tile = block_k * block_n * 4
    x_tile = block_m * block_k // 8 if packed else block_m * block_k
    cur_bytes = gm * gn * block_m * block_n * 4      # cached residual
    dx_out = gm * gk * block_m * block_k * 4
    dw_out = gk * gn * block_k * block_n * 4
    if kernels == "reference":
        recompute = gm * gk * x_tile + gk * gn * w_tile
        dx_bytes = m * n * 4 + k * n * 4 + dx_out
        dw_bytes = (gm * gk * x_tile) + m * n * 4 + dw_out
        return {"hbm_bytes": dx_bytes + dw_bytes + recompute,
                "dx_hbm_bytes": dx_bytes + recompute,
                "dw_hbm_bytes": dw_bytes,
                "flops": 4.0 * m * n * k, "mxu_eff": 1.0,
                "overhead_s": 0.0}
    dx_bytes = (gm * gn * g_tile + gk * gn * w_tile) + dx_out + cur_bytes
    dx_flops = 2.0 * m * n * k
    overhead = 2 * costs.launch_overhead_s            # two sweeps
    meta_bytes = 4 * gm * gk                         # forward vld map
    if skip == "dense":
        dw_steps = gk * gn * gm
        dw_flops = 2.0 * m * n * k * active_frac
        eff = 1.0
    else:
        dw_steps = gk * gn * max(active_frac * gm, 1.0)
        dw_flops = 2.0 * m * n * k * active_frac
        eff = 1.0
        overhead += costs.gating_overhead_s
        meta_bytes += 4 * gk * (gm + 1)              # transposed kmap+nact
        if skip == "two_level":
            dw_flops *= occ_frac
            eff = costs.subtile_eff
            meta_bytes += 4 * gm * gk                # occ bitmap
    dw_bytes = dw_steps * (x_tile + g_tile) + dw_out + meta_bytes
    # only dw's stripe steps run below the full rate: one blended rate
    # keeps kernel_time_s exact (dx/peak + dw/(peak*eff))
    total_flops = dx_flops + dw_flops
    weighted = dx_flops + dw_flops / max(eff, 1e-3)
    return {"hbm_bytes": dx_bytes + dw_bytes,
            "dx_hbm_bytes": dx_bytes, "dw_hbm_bytes": dw_bytes,
            "flops": total_flops, "mxu_eff": total_flops / weighted,
            "overhead_s": overhead}


def qk_chain_traffic(tokens: int, d_model: int, heads: int, head_dim: int,
                     kv_heads: int | None = None, *, packed: bool = False,
                     block_m: int = 128, block_n: int = 128,
                     block_k: int = 128, active_frac: float = 1.0,
                     costs: CostModel = H100) -> dict:
    """Byte model of the spiking QK attention chain (the reference's
    arithmetic): the fused head-blocked write-back (two fused_pe passes,
    the K pass re-reading the Q map for its row sums and emitting the
    masked map) against the composed projections + outside mask (unmasked
    maps out, a mask pass reading Q and K, and for grouped KV the
    replicated copy written and read). ``packed`` prices spike maps at one
    bit a spike. Returns {"fused_hbm_bytes", "composed_hbm_bytes", ...}."""
    hkv = heads if kv_heads is None else kv_heads
    nq = heads * head_dim
    spike_bytes = (1 / 8) if packed else 1.0

    def proj(n_cols: int) -> float:
        return spike_matmul_traffic(
            tokens, d_model, n_cols, block_m=block_m, block_n=block_n,
            block_k=block_k, active_frac=active_frac, packed=packed,
            skip="dense", costs=costs)["hbm_bytes"]

    q_map = tokens * nq * spike_bytes
    k_grouped_map = tokens * hkv * head_dim * spike_bytes
    k_expanded_map = tokens * nq * spike_bytes

    fused = proj(nq) + proj(nq) + q_map
    composed = (proj(nq) + proj(hkv * head_dim)
                + q_map + k_grouped_map + k_expanded_map)
    if hkv != heads:
        composed += 2 * k_expanded_map      # the expanded KV round trip
    return {"fused_hbm_bytes": fused, "composed_hbm_bytes": composed,
            "tokens": tokens, "d_model": d_model, "heads": heads,
            "head_dim": head_dim, "kv_heads": hkv, "packed": packed}


def kernel_time_s(traffic: dict, costs: CostModel = H100) -> float:
    """Roofline time of one modeled kernel: max(compute, memory) plus its
    fixed overhead."""
    compute = traffic["flops"] / (costs.peak_flops
                                  * max(traffic["mxu_eff"], 1e-3))
    memory = traffic["hbm_bytes"] / costs.hbm_bw
    return max(compute, memory) + traffic.get("overhead_s", 0.0)


# ----------------------------------------------------------------- report
def analyze_cell(rec: dict, chip: Chip = H100_SXM) -> dict:
    """One dry-run cell -> its three terms, bound, useful ratio, roofline
    fraction and footprint. A cell without a trace has its argument bytes
    only: its terms are None and its bound "not ported"."""
    n = rec["n_chips"]
    hlo = rec.get("hlo")
    mem = rec.get("memory_analysis", {})
    hbm = (mem.get("argument_size_in_bytes", 0) or 0) + \
          (mem.get("temp_size_in_bytes", 0) or 0)
    cell = {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "tag": rec.get("tag", ""), "model_flops": rec["model_flops"],
            "hbm_bytes": hbm, "fits": hbm <= chip.hbm_per_chip}
    if hlo is None:
        return dict(cell, compute_s=None, memory_s=None, collective_s=None,
                    bound="not ported", useful_ratio=None,
                    roofline_fraction=None, step_time_s=None,
                    collectives={}, ported=False)
    compute = hlo["flops"] / chip.peak_flops
    memory = hlo["bytes"] / chip.hbm_bw
    collective = hlo["collective_wire_bytes"] / chip.link_bw
    terms = {"compute": compute, "memory": memory, "collective": collective}
    bound = max(terms, key=terms.get)
    useful = rec["model_flops"] / max(n * hlo["flops"], 1e-30)
    ideal = rec["model_flops"] / n / chip.peak_flops
    frac = ideal / max(max(terms.values()), 1e-30)
    return dict(cell, compute_s=compute, memory_s=memory,
                collective_s=collective, bound=bound, useful_ratio=useful,
                roofline_fraction=frac, step_time_s=max(terms.values()),
                collectives=hlo.get("collectives", {}), ported=True)


def suggestion(cell: dict) -> str:
    """One sentence on what would move the dominant term down."""
    b = cell["bound"]
    if b == "not ported":
        return ("trace not ported (tensor parallelism, ROADMAP queue 1 item "
                f"6): only the argument bytes are known, "
                f"{cell['hbm_bytes'] / 1e9:.3f} GB a device")
    colls = cell.get("collectives", {})
    big = max(colls.items(), key=lambda kv: kv[1]["wire_bytes"])[0] \
        if colls else "none"
    if b == "collective":
        return (f"collective-bound (top op: {big}) — reshard to cut {big} "
                "volume (more DP / fewer TP boundaries, or overlap via "
                "collective-matmul)")
    if b == "memory":
        if cell["useful_ratio"] < 0.5:
            return ("memory-bound with low useful-FLOP ratio — remove "
                    "redundant passes (remat policy / fusion) before "
                    "touching layout")
        return ("memory-bound — increase arithmetic intensity: larger "
                "per-device batch, fused kernels, lower-precision "
                "weights/KV (int8)")
    return ("compute-bound — already at the right wall; chase MXU "
            "utilization (tile alignment, bf16 accumulation) and overlap "
            "the remaining comms")


def load(dirpath: Path, mesh: str | None, tag: str = "",
         chip: Chip = H100_SXM) -> list[dict]:
    cells = []
    for p in sorted(dirpath.glob("*.json")):
        rec = json.loads(p.read_text())
        if mesh and rec["mesh"] != mesh:
            continue
        if (rec.get("tag") or "") != tag:
            continue
        cells.append(analyze_cell(rec, chip))
    return cells


def _num(x, fmt: str) -> str:
    return "not ported" if x is None else format(x, fmt)


def markdown(cells: list[dict], chip: Chip = H100_SXM) -> str:
    hdr = ("| arch | shape | mesh | compute (s) | memory (s) | collective (s) "
           f"| bound | useful | roofline frac | fits "
           f"{chip.hbm_per_chip / 1e9:.0f}G |")
    sep = "|" + "---|" * 10
    rows = [hdr, sep]
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"], c["mesh"])):
        fits = "yes" if c["fits"] else "NO"
        if c["bound"] == "not ported":         # its arguments alone
            fits += f" ({c['hbm_bytes'] / 1e9:.3f} GB of arguments)"
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {_num(c['compute_s'], '.3e')} | {_num(c['memory_s'], '.3e')} "
            f"| {_num(c['collective_s'], '.3e')} | **{c['bound']}** "
            f"| {_num(c['useful_ratio'], '.2f')} "
            f"| {_num(c['roofline_fraction'], '.3f')} "
            f"| {fits} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", type=Path, default=DEFAULT_DIR)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--suggest", action="store_true")
    args = ap.parse_args(argv)

    cells = load(args.dir, args.mesh, args.tag)
    print(f"priced as one {H100_SXM.name}: "
          f"{H100_SXM.peak_flops / 1e12:.1f} TFLOP/s, "
          f"{H100_SXM.hbm_bw / 1e12:.2f} TB/s HBM, "
          f"{H100_SXM.link_bw / 1e9:.0f} GB/s link (data sheet)")
    print(markdown(cells))
    if args.suggest:
        print()
        for c in cells:
            print(f"- {c['arch']} x {c['shape']} ({c['mesh']}): "
                  f"{suggestion(c)}")
    if args.json:
        args.json.write_text(json.dumps(cells, indent=1))


if __name__ == "__main__":
    main()
