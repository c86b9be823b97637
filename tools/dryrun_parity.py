"""Per-chip dry-run costs of the port against the JAX package's, at full
size, one table.

    python3 tools/dryrun_parity.py jax --out OUT/jax.json
    python3 tools/dryrun_parity.py port --tree change=src \
        --tree parent=build/parent/src --out OUT/port.json
    python3 tools/dryrun_parity.py table --jax OUT/jax.json --port OUT/port.json

``--cell ARCH:SHAPE`` (repeatable) replaces the seven cells of ``jax`` and
``port``; ``table`` lists the cells of the JAX record.

``jax`` needs the JAX package (``src/repro``): each cell compiles in a
process of its own on 256 virtual CPU devices (``XLA_FLAGS`` is set before
JAX starts) over a ("data", "model") 16x16 mesh built with Auto axes
(``repro.launch.mesh.make_production_mesh`` builds Explicit ones, which
the JAX package's ``shard()`` cannot lower under JAX 0.9).  The record is
the JAX ``analyze_cell``'s: the costs from ``measure_costs`` (two reduced
depths at its run config ``run_m``, extrapolated), the memory from the
compile at the cell's own run config, plus the elements of the converts
XLA's CPU backend adds to run bfloat16 in float32 (each counted as one
FLOP; :func:`emulation_converts`), extrapolated the same way.

``port`` runs ``python -m repro_torch.launch.dryrun --arch A --shape S``
for each tree (``name=DIR`` of a tree's ``src``) and cell, on the card's
``cuda`` mesh (which records the MoE dispatch's all-to-all); ``--jobs``
cells at once.

``table`` prints, per cell, each side's FLOPs and bytes a chip, collective
GB by op and memory a device, and the port's ratios to JAX (FLOPs also
net of the converts).

``peak`` lists what one side holds at its memory peak, in a cell's own run
config (the record's ``memory``), by buffer:

    python3 tools/dryrun_parity.py peak jax --cell zamba2-7b:train_4k
    python3 tools/dryrun_parity.py peak port --cell zamba2-7b:train_4k

``jax`` reads the live ranges at the peak from the buffer assignment XLA
dumps for the compile (each buffer with its HLO shape and the JAX
operation it came from); ``port`` traces the step on the card's ``cuda``
mesh with ``OpTrace(detail=True)`` (each storage by the operation that
allocated it, same-shaped ones summed).
"""

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

#: the seven cells of the comparison: (arch, shape)
CELLS = (("granite-3-2b", "decode_32k"), ("granite-3-2b", "prefill_32k"),
         ("granite-3-2b", "train_4k"), ("mamba2-130m", "decode_32k"),
         ("mamba2-130m", "train_4k"), ("qwen2.5-32b", "train_4k"),
         ("zamba2-7b", "train_4k"))

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
GATHER_OPS = ("all-gather", "all-to-all", "collective-permute")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emulation_converts(text: str) -> int:
    """Elements of the converts XLA's CPU backend adds to a compiled
    module (HLO text) to run bfloat16 operations in float32: every
    ``convert`` that does not stand for the program's own
    ``convert_element_type``.  Reducer bodies are skipped."""
    reducers = set(re.findall(r"to_apply=%?([\w.\-]+)", text))
    total, comp = 0, None
    for line in text.splitlines():
        if line and not line.startswith(" "):
            m = re.match(r"(?:ENTRY )?%?([\w.\-]+)", line)
            comp = m.group(1) if m else None
            continue
        if comp in reducers:
            continue
        m = re.match(r"\s*(?:ROOT )?%?[\w.\-]+ = \w+\[([\d,]*)\]\S* convert\(",
                     line)
        if not m:
            continue
        name = re.search(r'op_name="([^"]+)"', line)
        if name and name.group(1).endswith("convert_element_type"):
            continue
        n = 1
        for x in m.group(1).split(","):
            if x:
                n *= int(x)
        total += n
    return total


def jax_cell(arch: str, shape_name: str, devices: int) -> dict:
    """The JAX record of one cell (call in a fresh process: it sets
    ``XLA_FLAGS`` before JAX starts)."""
    import dataclasses
    import time
    os.environ["JAX_PLATFORMS"] = "cpu"
    from repro.launch import dryrun as d      # sets XLA_FLAGS to 512
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{devices}")
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.dist import sharding
    from repro.models.config import SHAPES

    side = int(round(devices ** 0.5))
    mesh = jax.make_mesh((side, side), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:side * side])
    cfg, shape = get_arch(arch).full, SHAPES[shape_name]
    run = d.default_run_config(arch, shape_name)
    opt = d.default_opt_config(arch)
    rules = dict(sharding.DEFAULT_RULES, **d.default_rules_override(arch))
    t0 = time.perf_counter()
    run_m = dataclasses.replace(run, scan_blocks=False, ce_chunk=0,
                                attn_chunk=0, microbatch=1)
    L1, L2, _ = d._measurement_depths(cfg)
    parts = []
    for L in (L1, L2):
        c = d._build_lowered(dataclasses.replace(cfg, num_layers=L), shape,
                             run_m, mesh, rules, opt).compile()
        costs = d._module_costs(c)
        costs["emulation"] = emulation_converts(c.as_text())
        parts.append(costs)
    if cfg.family == "hybrid":
        n_units = cfg.num_layers / (cfg.hybrid_mamba_per_attn + 1)
    elif cfg.is_moe:
        n_units = cfg.num_layers - cfg.moe_first_dense
    else:
        n_units = cfg.num_layers
    costs = d._extrapolate(parts[0], parts[1], n_units)
    e1, e2 = parts[0]["emulation"], parts[1]["emulation"]
    costs["emulation"] = e1 + (n_units - 1) * max(0, e2 - e1)
    measure_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mem = d._mem_analysis(d._build_lowered(cfg, shape, run, mesh, rules,
                                           opt).compile())
    return {"arch": arch, "shape": shape_name, "mesh": f"{side}x{side}",
            "flops_per_chip": costs["flops"],
            "bytes_per_chip": costs["bytes"],
            "emulation_converts": costs["emulation"],
            "collective_by_op": costs["coll_by_op"],
            "collective_weighted_bytes": costs["coll_weighted"],
            "memory": mem, "measured_depths": [L1, L2],
            "measure_s": measure_s,
            "compile_s": time.perf_counter() - t0}


def jax_peak(arch: str, shape_name: str, devices: int, top: int,
             smoke: bool = False, seq: int = None, batch: int = None,
             run_m: bool = False, mesh_shape=None) -> dict:
    """The JAX compile's live buffers at its memory peak (call in a fresh
    process: it sets ``XLA_FLAGS`` before JAX starts), on a square
    ("data", "model") mesh of ``devices`` or ``mesh_shape``.  ``smoke``:
    the arch's smoke config at ``seq`` x ``batch``; ``run_m``: at
    ``measure_costs``' run config, as the cost records are."""
    import dataclasses
    import glob
    import tempfile
    os.environ["JAX_PLATFORMS"] = "cpu"
    from repro.launch import dryrun as d      # sets XLA_FLAGS to 512
    dump = tempfile.mkdtemp(prefix="dryrun_peak_")
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{devices} --xla_dump_to={dump}")
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.dist import sharding
    from repro.models.config import SHAPES, ShapeConfig

    side = int(round(devices ** 0.5))
    mesh_shape = tuple(mesh_shape or (side, side))
    mesh = jax.make_mesh(mesh_shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:mesh_shape[0]
                                               * mesh_shape[1]])
    if smoke:
        cfg = get_arch(arch).smoke
        shape = ShapeConfig(shape_name, seq, batch, SHAPES[shape_name].kind)
    else:
        cfg, shape = get_arch(arch).full, SHAPES[shape_name]
    run = d.default_run_config(arch, shape_name)
    if run_m:
        run = dataclasses.replace(run, scan_blocks=False, ce_chunk=0,
                                  attn_chunk=0, microbatch=1)
    mem = d._mem_analysis(d._build_lowered(
        cfg, shape, run, mesh,
        dict(sharding.DEFAULT_RULES, **d.default_rules_override(arch)),
        d.default_opt_config(arch)).compile())
    stem = glob.glob(os.path.join(
        dump, "*jit_step*cpu_after_optimizations-buffer-assignment.txt"))[0]
    with open(stem) as f:
        live = f.read().split("(peak):")[1].split("Stack trace")[0]
    with open(stem.replace("-buffer-assignment", "")) as f:
        hlo = f.read()
    buffers = []
    for m in re.finditer(r"\s+([\w.\-]+)\{[\d,]*\}: (\d+) bytes", live):
        name = m.group(1)
        line = re.search(r"%" + re.escape(name) + r" = (.*)", hlo)
        text = line.group(1) if line else ""
        op = re.search(r'op_name="([^"]+)"', text)
        buffers.append({"buffer": name, "bytes": int(m.group(2)),
                        "shape": text.split(" ")[0],
                        "op": op.group(1) if op else ""})
    return {"arch": arch, "shape": shape_name, "memory": mem,
            "live_bytes": sum(b["bytes"] for b in buffers),
            "buffers": buffers[:top]}


def dot_flops(text: str, op_name: str) -> list:
    """(output shape, contraction length, FLOPs) of every ``dot`` in a
    compiled module's HLO ``text`` whose JAX operation name contains
    ``op_name`` (an einsum's subscripts: its forward, recomputed and
    transposed products alike)."""
    shapes = {m.group(1): [int(x) for x in m.group(2).split(",") if x]
              for m in re.finditer(r"%([\w.\-]+) = \w+\[([\d,]*)\]", text)}
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*(?:ROOT )?%[\w.\-]+ = \w+\[([\d,]*)\]\S* "
                     r"dot\(%([\w.\-]+), %[\w.\-]+\), "
                     r"lhs_contracting_dims=\{([\d,]*)\}", line)
        name = re.search(r'op_name="([^"]+)"', line)
        if not m or not name or op_name not in name.group(1):
            continue
        res = [int(x) for x in m.group(1).split(",") if x]
        lhs = shapes[m.group(2)]
        k = 1
        for c in m.group(3).split(","):
            if c:
                k *= lhs[int(c)]
        n = 1
        for x in res:
            n *= x
        out.append((res, k, 2 * n * k))
    return out


def port_peak(arch: str, shape_name: str, top: int, cfg=None, shape=None,
              mesh_shape=None, run=None, device_type: str = "cuda") -> dict:
    """The port's trace on a fake-world mesh (the card's ``cuda`` one by
    default): what is live at its peak, by allocating operation, dtype
    and shape.  ``cfg``, ``shape``, ``mesh_shape`` and ``run`` replace the
    arch's full config, the cell's shape, the 16x16 mesh and the cell's
    run config."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES

    cfg = cfg or get_arch(arch).full
    shape = shape or SHAPES[shape_name]
    rules = dict(sharding.DEFAULT_RULES,
                 **dryrun.default_rules_override(arch))
    with dryrun._cell_mesh(False, mesh_shape, device_type) as mesh:
        trace = dryrun._traced_step(
            cfg, shape, run or dryrun.default_run_config(arch, shape_name),
            mesh, rules, dryrun.default_opt_config(arch), detail=True)
    groups = {}
    for op, dtype, shp, nb in trace.peak_live:
        g = groups.setdefault((op, str(dtype), shp), [0, 0])
        g[0] += 1
        g[1] += nb
    rows = sorted(groups.items(), key=lambda kv: -kv[1][1])
    return {"arch": arch, "shape": shape_name, "peak": trace.peak,
            "resident": trace.resident,
            "live_bytes": sum(nb for *_, nb in trace.peak_live),
            "buffers": [{"op": op, "dtype": dt, "shape": list(shp),
                         "count": n, "bytes": nb}
                        for (op, dt, shp), (n, nb) in rows[:top]]}


def run_peak(args):
    for cell in args.cell:
        arch, shape = cell.split(":")
        if args.which == "port":
            rec = port_peak(arch, shape, args.top)
        else:
            code = (f"import json, sys; sys.path.insert(0, "
                    f"{REPO + '/tools'!r}); import dryrun_parity as t; "
                    f"print(json.dumps(t.jax_peak({arch!r}, {shape!r}, "
                    f"{args.devices}, {args.top})))")
            env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
            done = subprocess.run([sys.executable, "-c", code], env=env,
                                  capture_output=True, text=True)
            if done.returncode:
                raise SystemExit(done.stderr[-3000:])
            rec = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)


def _cells(args):
    """The ``--cell ARCH:SHAPE`` cells given, else :data:`CELLS`."""
    return [tuple(c.split(":")) for c in args.cell] if args.cell else CELLS


def run_jax(args):
    out = {}
    for arch, shape in _cells(args):
        code = (f"import json, sys; sys.path.insert(0, {REPO + '/tools'!r}); "
                f"import dryrun_parity as t; print(json.dumps(t.jax_cell("
                f"{arch!r}, {shape!r}, {args.devices})))")
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        done = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True)
        if done.returncode:
            rec = {"arch": arch, "shape": shape, "error": done.stderr[-2000:]}
        else:
            rec = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps({k: rec.get(k) for k in (
            "arch", "shape", "flops_per_chip", "measure_s", "error")}),
            flush=True)
        out[f"{arch}|{shape}"] = rec
    _write(args.out, out)


def run_port(args):
    trees = dict(t.split("=", 1) for t in args.tree)
    jobs = [(name, arch, shape) for name in trees
            for arch, shape in _cells(args)]

    def one(job):
        name, arch, shape = job
        out_dir = os.path.join(args.records, name)
        env = dict(os.environ, PYTHONPATH=os.path.abspath(trees[name]))
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out_dir],
            env=env, capture_output=True, text=True)
        path = os.path.join(out_dir, f"{arch}__{shape}__single.json")
        if done.returncode or not os.path.exists(path):
            return name, arch, shape, {"status": "error",
                                       "error": done.stderr[-2000:]}
        with open(path) as f:
            rec = json.load(f)
        rec.pop("ops_by_name", None)
        return name, arch, shape, rec

    out = {}
    with ThreadPoolExecutor(args.jobs) as pool:
        for name, arch, shape, rec in pool.map(one, jobs):
            out.setdefault(name, {})[f"{arch}|{shape}"] = rec
            print(json.dumps({"tree": name, "arch": arch, "shape": shape,
                              "status": rec.get("status"),
                              "flops_per_chip": rec.get("flops_per_chip"),
                              "lower_s": rec.get("lower_s"),
                              "measure_s": rec.get("measure_s")}),
                  flush=True)
    _write(args.out, out)


def _write(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _gb(x):
    return f"{x / 1e9:.4g}"


def table(jax_recs, port_recs) -> str:
    """Markdown: per cell, JAX's figures and each tree's, with ratios."""
    cells = [tuple(k.split("|")) for k in jax_recs]
    lines = ["| cell | side | TFLOP/chip | ratio | net ratio | GB/chip | "
             "ratio | collectives GB (AR/AG/RS/A2A/CP) | gather-like ratio "
             "| GiB/device | ratio |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- "
             "| --- |"]
    for arch, shape in cells:
        key = f"{arch}|{shape}"
        j = jax_recs.get(key, {})
        if "flops_per_chip" not in j:
            lines.append(f"| {arch} {shape} | JAX | error | | | | | | | | |")
            continue
        jmem = j["memory"].get("total_bytes_per_device", 0.0)
        jgl = sum(j["collective_by_op"].get(k, 0) for k in GATHER_OPS)
        jnet = j["flops_per_chip"] - j["emulation_converts"]
        lines.append(
            f"| {arch} {shape} | JAX | {j['flops_per_chip'] / 1e12:.4g} "
            f"(net {jnet / 1e12:.4g}) | | | {_gb(j['bytes_per_chip'])} | | "
            + "/".join(_gb(j["collective_by_op"].get(k, 0))
                       for k in COLLECTIVES)
            + f" | | {jmem / 2 ** 30:.2f} | |")
        for name, recs in port_recs.items():
            p = recs.get(key, {})
            if p.get("status") != "ok":
                lines.append(f"| | {name} | {p.get('status', 'missing')} "
                             "| | | | | | | | |")
                continue
            pmem = p["memory"]["total_bytes_per_device"]
            pgl = sum(p["collective_by_op"].get(k, 0) for k in GATHER_OPS)
            lines.append(
                f"| | {name} | {p['flops_per_chip'] / 1e12:.4g} | "
                f"{p['flops_per_chip'] / j['flops_per_chip']:.3f} | "
                f"{p['flops_per_chip'] / jnet:.3f} | "
                f"{_gb(p['bytes_per_chip'])} | "
                f"{p['bytes_per_chip'] / j['bytes_per_chip']:.3f} | "
                + "/".join(_gb(p["collective_by_op"].get(k, 0))
                           for k in COLLECTIVES)
                + f" | {(pgl / jgl if jgl else float('nan')):.3f} | "
                f"{pmem / 2 ** 30:.2f} | "
                f"{(pmem / jmem if jmem else float('nan')):.3f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="side", required=True)
    j = sub.add_parser("jax")
    j.add_argument("--out", required=True)
    j.add_argument("--devices", type=int, default=256)
    j.add_argument("--cell", action="append",
                   help="ARCH:SHAPE (repeatable; default: the seven cells)")
    p = sub.add_parser("port")
    p.add_argument("--cell", action="append",
                   help="ARCH:SHAPE (repeatable; default: the seven cells)")
    p.add_argument("--tree", action="append", required=True,
                   help="name=DIR of a tree's src")
    p.add_argument("--out", required=True)
    p.add_argument("--records", default="build/dryrun_parity",
                   help="where each tree's per-cell records are written")
    p.add_argument("--jobs", type=int, default=4)
    t = sub.add_parser("table")
    t.add_argument("--jax", required=True)
    t.add_argument("--port", required=True)
    k = sub.add_parser("peak")
    k.add_argument("which", choices=("jax", "port"))
    k.add_argument("--cell", action="append", required=True,
                   help="ARCH:SHAPE, e.g. zamba2-7b:train_4k")
    k.add_argument("--devices", type=int, default=256)
    k.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if args.side == "jax":
        run_jax(args)
    elif args.side == "port":
        run_port(args)
    elif args.side == "peak":
        run_peak(args)
    else:
        with open(args.jax) as f:
            jax_recs = json.load(f)
        with open(args.port) as f:
            port_recs = json.load(f)
        print(table(jax_recs, port_recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
