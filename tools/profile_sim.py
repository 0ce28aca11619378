"""Device-time breakdown of one steady sim window, attributed to source.

    python tools/profile_sim.py [--out chiprun_out/profile] [--reps 1]

Compiles bench.py's sim program (the BENCH_* / EKF_* environment picks the
mode, as for bench.py), warms it up, traces `--reps` calls with
jax.profiler, and reduces the trace:

* per HLO op: device time, kernel launches, bytes moved per execution
  (result + materialized operands, from the compiled HLO's shapes by
  tools/roofline.py's rules) and achieved bytes/s;
* the device's busy and idle share over the traced window;
* two source groups, each the ops whose HLO metadata names the line:
  `cov_apply`, the covariance apply P + Ā·B̄ᵀ of ekf.update's folded tail
  (and engine._apply_stacked_factors in the deferred parity form), and
  `predict_stripes`, the two dynamic_update_slice stripe writes of
  ekf.predict — with their device-time share and their bytes/s against
  the card's published bandwidth (tools/roofline.py PEAKS).

Writes summary.json, top_ops.txt and the compiled HLO under --out. Needs
the GPU (the device plane of the trace); elsewhere it exits non-zero.
"""

import argparse
import glob
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

_META_RE = re.compile(r'source_file="([^"]*)" source_line=(\d+)')
_FRAME_RE = re.compile(r"stack_frame_id=(\d+)")
_CALLS_RE = re.compile(r"calls=%?([\w.-]+)")
_TABLE_ROW = re.compile(r"^(\d+) (.*)$")
_KV = re.compile(r"(\w+)=(\d+)")


def stack_tables(text):
    """{stack_frame_id: {(file basename, line), ...}} from the FileNames /
    FileLocations / StackFrames tables of an HLO dump: every frame of the
    Python stack that created an op, innermost to outermost."""
    tables, cur = {}, None
    for line in text.splitlines():
        if line in ("FileNames", "FunctionNames", "FileLocations",
                    "StackFrames"):
            cur = tables.setdefault(line, {})
            continue
        m = _TABLE_ROW.match(line) if cur is not None else None
        if m is None:
            cur = None
            continue
        cur[int(m.group(1))] = m.group(2)
    files = {k: os.path.basename(v.strip('"'))
             for k, v in tables.get("FileNames", {}).items()}
    locs = {k: dict((a, int(b)) for a, b in _KV.findall(v))
            for k, v in tables.get("FileLocations", {}).items()}
    frames = {k: dict((a, int(b)) for a, b in _KV.findall(v))
              for k, v in tables.get("StackFrames", {}).items()}
    out = {}
    for fid in frames:
        chain, seen, f = set(), set(), fid
        while f in frames and f not in seen:
            seen.add(f)
            loc = locs.get(frames[f].get("file_location_id"), {})
            if loc:
                chain.add((files.get(loc["file_name_id"], "?"),
                           loc["line"]))
            f = frames[f].get("parent_frame_id")
        out[fid] = chain
    return out


def _op_sources(rhs, frames):
    found = {(os.path.basename(f), int(ln))
             for f, ln in _META_RE.findall(rhs)}
    for fid in _FRAME_RE.findall(rhs):
        found |= frames.get(int(fid), set())
    return found


def _source_lines(path, patterns):
    """1-based line numbers of `path` whose text contains any pattern."""
    with open(path) as f:
        return {i + 1 for i, ln in enumerate(f)
                if any(p in ln for p in patterns)}


def source_groups():
    """{group: {(file basename, line)}} for the two covariance-traffic
    candidates, found by their code text so edits do not stale them."""
    ekf = os.path.join(REPO, "ekf_slam_tpu", "filter", "ekf.py")
    eng = os.path.join(REPO, "ekf_slam_tpu", "filter", "engine.py")
    apply_ = {("ekf.py", n) for n in _source_lines(
        ekf, ["P_new = p_compute(P) + A_f @ B_f.T",
              "P_new = p_compute(P) + corr"])}
    apply_ |= {("engine.py", n) for n in _source_lines(
        eng, ["return ekf.p_store(ekf.p_compute(P) + A @ B.T, P)"])}
    stripes = set()
    with open(ekf) as f:
        lines = f.readlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("def predict("))
    end = next(i for i in range(start + 1, len(lines))
               if lines[i].startswith("def "))
    # the default "pred" form: the last two stripe writes of predict,
    # including the argument line of the multi-line second call
    dus = [i for i in range(start, end)
           if "dynamic_update_slice(" in lines[i]][-2:]
    for i in dus:
        stripes |= {("ekf.py", i + 1), ("ekf.py", i + 2)}
    return {"cov_apply": apply_, "predict_stripes": stripes}


def hlo_index(text):
    """{instruction name: (computation, set of (file, line))}, folding
    each fusion's called computation into the fusion's source set."""
    import roofline
    comps = roofline.parse_computations(text)
    frames = stack_tables(text)
    src, rhs_of = {}, {}
    for comp, instrs in comps.items():
        if comp == "__entry__":
            continue
        for name, _opc, _b, rhs, _root in instrs:
            src[name] = (comp, _op_sources(rhs, frames))
            rhs_of[name] = rhs
    for name, (comp, s) in list(src.items()):
        m = _CALLS_RE.search(rhs_of[name])
        if m and m.group(1) in comps:
            for _n2, _o, _b, r2, _rt in comps[m.group(1)]:
                s |= _op_sources(r2, frames)
    return comps, src


def bytes_per_execution(comps):
    """{top-level instruction name: bytes read + written per execution}
    (tools/roofline.py traffic rules, every computation)."""
    import roofline
    result_bytes = {n: b for instrs in comps.values()
                    for n, _o, b, _r, _rt in instrs}
    out = {}
    for comp, instrs in comps.items():
        _, rows = roofline.computation_traffic(instrs, result_bytes, comps)
        for b, name, _opc in rows:
            out.setdefault(name, b)
    return out


def reduce_trace(pd, plane_prefix="/device:GPU"):
    """Per-HLO-op device time from a ProfileData: ({hlo_op: [ns, n]},
    busy ns, window ns). Busy is the union of all kernel intervals on the
    matching planes; the window runs from the first kernel start to the
    last kernel end."""
    per_op, ivs = {}, []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                ivs.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                op = st.get("hlo_op")
                if op is None:
                    continue
                acc = per_op.setdefault(op, [0.0, 0])
                acc[0] += ev.duration_ns
                acc[1] += 1
    if not ivs:
        return per_op, 0.0, 0.0
    ivs.sort()
    busy, (cs, ce) = 0.0, ivs[0]
    for s, e in ivs[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    return per_op, busy, ivs[-1][1] - ivs[0][0] if ivs else 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "profile"))
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()

    # Command buffers (CUDA graphs) would report every kernel of the step
    # under one "command_buffer" op; launch kernels one by one instead so
    # each carries its HLO op (the traced window, not end-to-end numbers).
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    import bench
    import jax
    from jax.profiler import ProfileData

    from ekf_slam_tpu.filter import ekf

    import roofline

    info = bench.require_gpu()
    bench.enable_compile_cache()
    pk = roofline.peaks_for(info["device_kind"])
    cfg = bench.sim_config()
    run, fargs, rep_args, _ = bench.sim_program(cfg, bench.BATCH,
                                                bench.FRAMES)
    compiled = jax.jit(run).lower(*fargs).compile()
    text = compiled.as_text()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "hlo.txt"), "w") as f:
        f.write(text)
    for i in range(2):                                   # warm-up
        jax.block_until_ready(compiled(*rep_args(i)))
    tdir = os.path.join(args.out, "trace")
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        for i in range(args.reps):
            out = compiled(*rep_args(10 + i))
        jax.block_until_ready(out)
    wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    per_op, busy, window = reduce_trace(ProfileData.from_file(path))
    if not per_op:
        sys.exit("no device kernels with an hlo_op in the trace")

    comps, src = hlo_index(text)
    nbytes = bytes_per_execution(comps)
    # ops of the frame scan (the whiles in ENTRY) run FRAMES times per
    # call; anything else counts its kernel launches
    scan_bodies = {m.group(1) for _n, opc, _b, rhs, _r in comps["__entry__"]
                   if opc == "while"
                   for m in [roofline.BODY_RE.search(rhs)] if m}
    body_execs = bench.FRAMES * args.reps
    total_ns = sum(v[0] for v in per_op.values())
    rows = []
    for op, (ns, n) in per_op.items():
        comp, lines = src.get(op, ("?", set()))
        execs = body_execs if comp in scan_bodies else n
        b = nbytes.get(op, 0) * execs
        rows.append({"op": op, "ns": ns, "kernels": n, "execs": execs,
                     "bytes": b, "bytes_per_s": b / (ns * 1e-9) if ns else 0,
                     "comp": comp, "lines": sorted(lines)})
    rows.sort(key=lambda r: -r["ns"])

    groups = {}
    for g, keyset in source_groups().items():
        sel = [r for r in rows if keyset & set(map(tuple, r["lines"]))]
        ns = sum(r["ns"] for r in sel)
        b = sum(r["bytes"] for r in sel)
        groups[g] = {
            "ops": [r["op"] for r in sel], "device_ns": ns,
            "share_of_kernel_time": ns / total_ns,
            "bytes": b, "bytes_per_s": b / (ns * 1e-9) if ns else 0.0,
            "share_of_peak_bw": (b / (ns * 1e-9) / pk["hbm_bytes_per_s"]
                                 if ns else 0.0),
            "source_lines": sorted(keyset)}
    summary = {
        "device": info, "peaks": pk, "batch": bench.BATCH,
        "frames": bench.FRAMES, "reps": args.reps,
        "precision": ekf._COV_PRECISION,
        "p_storage": cfg.filter.p_storage, "wall_s": wall,
        "command_buffers": "disabled for the trace",
        "kernel_ns": total_ns, "busy_ns": busy, "window_ns": window,
        "idle_share": 1.0 - busy / window if window else None,
        "groups": groups, "top_ops": rows[:40]}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    with open(os.path.join(args.out, "top_ops.txt"), "w") as f:
        for r in rows:
            f.write(f"{r['ns'] / 1e3:10.1f} us {r['kernels']:5d} k "
                    f"{r['bytes'] / 1e6:9.2f} MB {r['bytes_per_s'] / 1e9:8.1f}"
                    f" GB/s  {r['op']:<28} {r['comp'][:24]:<24} "
                    f"{r['lines'][:4]}\n")
    print(json.dumps({k: v for k, v in summary.items() if k != "top_ops"},
                     default=str))


if __name__ == "__main__":
    main()
