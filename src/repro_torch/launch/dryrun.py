"""Multi-pod dry run: every (arch x shape x mesh) cell, on fake tensors
(twin of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step against the production
mesh and reads XLA's memory and cost analyses. The port has no compiler to
ask, so a cell has two halves:

  * the spec half, at every mesh: a ``launch.mesh.Mesh`` of the mode's
    shape (no ranks needed) and the sharding specs (``models.sharding``)
    give the per-device bytes of the parameters (``param_specs``), the
    AdamW moments (``zero1_specs``), the batch (``batch_specs``) and the
    decode cache (``cache_specs``, context-parallel for ``long_500k``);
    with ``param_count``, ``active_param_count`` and the analytic
    ``model_flops`` (6 N D to train, 2 N D to infer);
  * the trace half: rank 0's step on fake CPU tensors at its per-device
    shapes, recorded by ``launch.hlo_analysis.OpRecorder`` (flops, bytes,
    collectives, the memory fields). ``train`` runs
    ``train.make_train_step`` (loss, backward, clip, AdamW; ``--microbatch``)
    with its ``dp_group`` over the mesh's data-parallel axes: a process
    group of the mesh's size on torch's fake backend, which moves no data,
    so the per-leaf all-reduces are in the record. ``prefill`` runs
    ``model.prefill``, ``decode`` ``model.decode_step`` on a cache. A mesh
    whose ``model`` axis is larger than 1 needs tensor parallelism, which
    is not ported (ROADMAP queue 1 item 6): such a cell keeps its spec half
    and names the trace it could not make. The production meshes, (data 16,
    model 16) and (pod 2, data 16, model 16), are such meshes; ``run_cell``
    takes ``mesh=`` to trace at a model axis of 1.

Per cell the JSON holds ``per_device_bytes`` (the spec half),
``memory_analysis`` (the trace's, or the spec half's argument bytes),
``hlo`` (``hlo_analysis.analyze`` of the record, or None), ``model_flops``,
``param_count`` and ``active_param_count``. The op record goes beside it,
gzipped (``<cell>.ops.gz``, one JSON entry a line), the twin of the
reference's ``.hlo.gz``. Outputs go under ``build/`` unless ``--outdir``
says otherwise.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--outdir build/dryrun]
  python -m repro_torch.launch.dryrun --list
``--all`` runs each cell in a fresh subprocess and skips cells whose JSON
already exists (``--force`` runs them again).
"""
import argparse
import ast
import contextlib
import gzip
import json
import math
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

DEFAULT_OUTDIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
UNPORTED = ("tensor / expert parallelism over a 'model' axis of {} is not "
            "ported yet (ROADMAP queue 1 item 6): the trace half needs a "
            "model axis of 1")


def _cells(mesh_modes: list[str]):
    from ..configs import ARCHS, cells_for
    out = []
    for name, cfg in ARCHS.items():
        for shape in cells_for(cfg):
            for mesh in mesh_modes:
                out.append((name, shape, mesh))
    return out


def production_mesh(mesh_mode: str):
    """The production mesh of a mode as a ``launch.mesh.Mesh`` of no ranks:
    (data 16, model 16), or (pod 2, data 16, model 16) for ``multi``."""
    from .mesh import Mesh

    if mesh_mode == "multi":
        return Mesh((2, 16, 16), ("pod", "data", "model"), device="cpu")
    return Mesh((16, 16), ("data", "model"), device="cpu")


# ------------------------------------------------------------ spec half
def local_shape(shape, spec, mesh) -> tuple:
    """One device's shard of a dimension tuple split by ``spec``."""
    from ..models.sharding import _axis_size

    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _axis_size(mesh, s) for d, s in zip(shape, spec))


def _shard_bytes(tree, specs, mesh) -> int:
    from ..tree import tree_leaves, tree_map

    return sum(tree_leaves(tree_map(
        lambda t, spec: t.dtype.itemsize * math.prod(
            local_shape(tuple(t.shape), spec, mesh)), tree, specs)))


def _inputs(model, shape, mesh) -> dict:
    """The step's inputs besides its state, each as (meta-tensor tree,
    sharding specs): the batch (train and prefill) or the tokens and the
    cache (decode, context-parallel for ``long_500k``)."""
    from ..models import sharding as shd

    specs = model.input_specs(shape)
    if shape.kind != "decode":
        return {"batch": (specs["batch"], shd.batch_specs(specs["batch"],
                                                          mesh))}
    return {"batch": (specs["tokens"], shd.batch_specs(specs["tokens"],
                                                       mesh)),
            "cache": (specs["cache"], shd.cache_specs(
                specs["cache"], mesh, batch=shape.global_batch,
                context_parallel=(shape.name == "long_500k"),
                seq_axis=model.cfg.decode_cp_axis or None))}


def per_device_bytes(model, shape, mesh, params, opt_state=None) -> dict:
    """Bytes on one device by the sharding specs: the parameters; to train,
    the AdamW state (its step counter, the moments by ``zero1_specs``) and
    the train state's step counter; the batch (train and prefill) or the
    tokens and the cache (decode); and their sum, ``arguments``."""
    from ..models import sharding as shd

    out = {"params": _shard_bytes(params, shd.param_specs(params, mesh),
                                  mesh)}
    if shape.kind == "train":
        z1 = shd.zero1_specs(params, mesh)
        out["opt_state"] = (opt_state.step.element_size()
                            + _shard_bytes(opt_state.m, z1, mesh)
                            + _shard_bytes(opt_state.v, z1, mesh))
        out["step"] = 4                       # TrainState.step, int32
    for name, (meta, specs) in _inputs(model, shape, mesh).items():
        out[name] = _shard_bytes(meta, specs, mesh)
    out["arguments"] = sum(out.values())
    return out


# ----------------------------------------------------------- trace half
@contextlib.contextmanager
def fake_world(size: int):
    """A process group of ``size`` ranks on torch's fake backend, this
    process rank 0: collectives are dispatched (and recorded) and move no
    data. Destroyed at the end."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run's trace makes its own process group "
                           "(the fake backend): call it with none running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_inputs(meta_tree, specs, mesh):
    """Fake CPU tensors of one device's shards of a meta-tensor tree."""
    import torch

    from ..tree import tree_map

    return tree_map(lambda t, spec: torch.zeros(
        local_shape(tuple(t.shape), spec, mesh), dtype=t.dtype),
        meta_tree, specs)


def trace_step(model, shape, mesh, params, opt_state=None, *,
               microbatch: int = 0):
    """Rank 0's step of a cell on fake CPU tensors at its per-device
    shapes, under an ``OpRecorder``: (the recorder, the step's outputs).
    ``params`` / ``opt_state`` are fake trees (``module_param_shapes``,
    ``optimizer_shapes``). Raises ``NotImplementedError`` on a mesh whose
    ``model`` axis is larger than 1 (ROADMAP queue 1 item 6)."""
    import torch

    from ..models import sharding as shd
    from ..optim import constant_lr
    from ..tree import tree_leaves
    from ..train import TrainState, make_train_step
    from .hlo_analysis import OpRecorder

    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(UNPORTED.format(mesh.shape["model"]))
    mode = tree_leaves(params)[0].fake_mode
    with mode, warnings.catch_warnings():
        # a kernel wrapper's CPU branch asks a fake tensor for its address
        # (alignment), which torch warns about
        warnings.filterwarnings(
            "ignore", message="Accessing the data pointer of FakeTensor")
        inputs = {name: _fake_inputs(meta, specs, mesh) for name,
                  (meta, specs) in _inputs(model, shape, mesh).items()}
        batch = inputs["batch"]
        if shape.kind == "decode":
            cache = inputs["cache"]
            with OpRecorder((params, batch, cache), donated=cache) as rec:
                out = model.decode_step(params, batch, cache)
            return rec, out
        if shape.kind == "prefill":
            with OpRecorder((params, batch)) as rec:
                out = model.prefill(params, batch)
            return rec, out
        state = TrainState(step=torch.zeros((), dtype=torch.int32),
                           params=params, opt_state=opt_state)
        with fake_world(mesh.size):
            step = make_train_step(
                model, schedule=constant_lr(3e-4), weight_decay=0.1,
                clip_norm=1.0, microbatch=microbatch,
                dp_group=mesh.get_group(shd.dp_axes(mesh)))
            with OpRecorder((state, batch), donated=state) as rec:
                out = step(state, batch)
        return rec, out


def write_ops(path: Path, record: list) -> None:
    """The op record, gzipped, one JSON entry a line."""
    path.write_bytes(gzip.compress(
        "".join(json.dumps(e) + "\n" for e in record).encode()))


def read_ops(path: Path) -> list:
    return [json.loads(line) for line in
            gzip.decompress(path.read_bytes()).decode().splitlines()]


# --------------------------------------------------------------- single cell
@contextlib.contextmanager
def _installed(mesh):
    """``mesh`` as the global mesh inside the block."""
    from ..models import sharding as shd

    prev = shd.get_global_mesh()
    shd.set_global_mesh(mesh)
    try:
        yield
    finally:
        shd.set_global_mesh(prev)


def spec_record(arch: str, cfg, model, shape, mesh_mode: str, mesh, params,
                opt_state=None, *, tag: str = "",
                overrides: dict | None = None) -> dict:
    """A cell's record with its spec half: the fields every cell has, the
    trace's (``memory_analysis``, ``hlo``, ``ops``, ``trace``) left for
    the trace to fill (the argument bytes, and no trace, until then)."""
    with _installed(mesh):
        spec = per_device_bytes(model, shape, mesh, params, opt_state)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_mode, "tag": tag,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "n_chips": int(mesh.size),
        "mesh_shape": {k: int(v) for k, v in mesh.shape.items()},
        "per_device_bytes": spec,
        "memory_analysis": {"argument_size_in_bytes": spec["arguments"]},
        "trace": {"ported": False, "reason": (
            UNPORTED.format(mesh.shape["model"])
            if mesh.shape.get("model", 1) > 1 else "not traced")},
        "hlo": None,
        "ops": None,
        "model_flops": analytic_model_flops(cfg, params, shape),
        "param_count": param_count(params),
        "active_param_count": active_param_count(cfg, params),
    }


def spec_records(mesh_modes: list[str]) -> list[dict]:
    """The spec half of every registry cell at each mesh mode (no trace;
    each architecture's shapes walked once)."""
    from ..analysis.abstract import module_param_shapes, optimizer_shapes
    from ..configs import ARCHS, SHAPES, build_model, cells_for
    from ..optim import adamw_init

    out = []
    for arch, cfg in ARCHS.items():
        model = build_model(cfg)
        params = module_param_shapes(model.init)
        opt = optimizer_shapes(adamw_init, params)
        for name in cells_for(cfg):
            for mode in mesh_modes:
                out.append(spec_record(arch, cfg, model, SHAPES[name], mode,
                                       production_mesh(mode), params, opt))
    return out


def run_cell(arch: str, shape_name, mesh_mode: str, outdir: Path,
             overrides: dict | None = None, tag: str = "",
             microbatch: int = 0, mesh=None) -> dict:
    """One cell: its spec half at ``mesh`` (the mode's production mesh
    when None), and its trace half where the mesh's ``model`` axis is 1.
    ``shape_name``: a name of ``configs.SHAPES`` or a ``ShapeSpec``.
    Writes the cell's JSON (and its op record) under ``outdir`` and
    returns the result."""
    from ..analysis.abstract import module_param_shapes, optimizer_shapes
    from ..configs import SHAPES, build_model, get_config
    from ..configs.base import ShapeSpec
    from ..optim import adamw_init
    from . import hlo_analysis

    t0 = time.time()
    cfg = get_config(arch, **(overrides or {}))
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    model = build_model(cfg)
    mesh = mesh if mesh is not None else production_mesh(mesh_mode)
    params = module_param_shapes(model.init)
    opt = (optimizer_shapes(adamw_init, params)
           if shape.kind == "train" else None)
    result = spec_record(arch, cfg, model, shape, mesh_mode, mesh, params,
                         opt, tag=tag, overrides=overrides)
    t_spec = time.time()
    record = None
    try:
        with _installed(mesh):
            rec, out = trace_step(model, shape, mesh, params, opt,
                                  microbatch=microbatch)
        record = rec.record
        result.update(memory_analysis=rec.memory_analysis(out),
                      hlo=hlo_analysis.analyze(record), ops=len(record),
                      trace={"ported": True})
        del out
    except NotImplementedError as e:
        result["trace"] = {"ported": False, "reason": str(e)}
    result.update(spec_s=round(t_spec - t0, 2),
                  trace_s=round(time.time() - t_spec, 2))
    outdir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    stem = f"{arch}__{shape.name}__{mesh_mode}{suffix}"
    if record is not None:
        write_ops(outdir / f"{stem}.ops.gz", record)
    path = outdir / f"{stem}.json"
    path.write_text(json.dumps(result, indent=1))
    what = ("" if record is not None else
            " (spec half; the trace waits for ROADMAP queue 1 item 6)")
    print(f"[dryrun] OK {arch} {shape.name} {mesh_mode}{what} "
          f"spec={result['spec_s']}s trace={result['trace_s']}s -> {path}")
    return result


# ----------------------------------------------------------- analytic flops
def param_count(params_shape) -> int:
    from ..tree import tree_leaves
    return sum(math.prod(t.shape) for t in tree_leaves(params_shape))


def active_param_count(cfg, params_shape) -> int:
    """Non-embedding params, MoE experts scaled by top_k/n_experts."""
    from ..tree import tree_leaves_with_path
    total = 0
    for path, leaf in tree_leaves_with_path(params_shape):
        ps = "/".join(str(k) for k in path)
        n = math.prod(leaf.shape)
        if "emb" in ps:
            continue
        if any(w in ps for w in ("w_gate", "w_up", "w_down")):
            n = n * cfg.top_k // max(cfg.n_experts, 1)
        total += n
    return total


def analytic_model_flops(cfg, params_shape, shape) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (inference),
    GLOBAL (all chips). D = processed tokens."""
    n = active_param_count(cfg, params_shape)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: 1 token per seq


# ------------------------------------------------------------------- driver
def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--outdir", type=Path, default=DEFAULT_OUTDIR)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="result-file suffix (perf runs)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override k=v (python literal)")
    ap.add_argument("--microbatch", type=int, default=0)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list or args.all:
        cells = _cells(meshes)
    if args.list:
        for c in cells:
            print(*c)
        return

    if args.all:
        failures, spec_only = [], []
        for arch, shape, mesh in cells:
            suffix = f"__{args.tag}" if args.tag else ""
            path = args.outdir / f"{arch}__{shape}__{mesh}{suffix}.json"
            if path.exists() and not args.force:
                print(f"[dryrun] skip (exists) {arch} {shape} {mesh}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--outdir", str(args.outdir)]
            if args.tag:
                cmd += ["--tag", args.tag]
            for ov in args.override:
                cmd += ["--override", ov]
            if args.microbatch:
                cmd += ["--microbatch", str(args.microbatch)]
            r = subprocess.run(cmd)
            if r.returncode != 0:
                failures.append((arch, shape, mesh))
                print(f"[dryrun] FAIL {arch} {shape} {mesh}")
            elif not json.loads(path.read_text())["trace"]["ported"]:
                spec_only.append((arch, shape, mesh))
        print(f"[dryrun] {len(spec_only)} cells kept their spec half only "
              f"(the trace waits for ROADMAP queue 1 item 6): {spec_only}")
        print(f"[dryrun] done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    try:
        run_cell(args.arch, args.shape, args.mesh, args.outdir,
                 overrides or None, args.tag, microbatch=args.microbatch)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
