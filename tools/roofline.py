"""Memory- and compute-roofline arithmetic from a compiled HLO dump.

The sim program is memory-bound in every form measured so far (the
covariance passes dominate), so the first ceiling is HBM bandwidth:

    steps/s ceiling = HBM bytes/s / (bytes moved per step)

This tool parses a `compiled.as_text()` dump (e.g. the hlo.txt
tools/profile_sim.py writes), finds the sequence-scan `while` loop (the
per-frame step body — the bench program is vmap(run_sequence) = one while
over FRAMES), and sums memory traffic per iteration over the body's
TOP-LEVEL instructions:

    traffic(instr) = bytes written (its result)
                   + bytes read   (its materialized operands)

Fusion-internal ops never materialize and are excluded. Aliasing ops
(tuple/get-tuple-element/bitcast/parameter) move no data and are skipped.
Library calls (cuBLAS/cuDNN `custom-call`s) read and write their operands
like any kernel and are counted. Re-reads of one buffer by several
consumers are counted each time (an upper bound where L2 would serve
them). Shapes are counted at their logical size: the GPU does not pad
arrays to tiles.

Peaks come from one table keyed by the JAX `device_kind` (PEAKS, with
its source); an unknown device is an error, never a default:

    python tools/roofline.py step.hlo --device-kind "NVIDIA H100 80GB HBM3" \
        --batch 256 --steps-per-sec <measured> [--flops] [--top 15]

The achieved-bytes/s statement assumes the while body dominates the
program (true for FRAMES>=16: entry-computation setup runs once per
FRAMES iterations) — the tool prints entry traffic too so you can check.
"""

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(__file__))
from analyze_hlo import BYTES, SHAPE_RE, logical_bytes  # noqa: E402

# Published peaks per device, keyed by jax.devices()[0].device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
# (no sparsity), at the full 700 W power limit; a card with a lower
# power.limit cannot hold its top clock under matrix-heavy load.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,          # outside the tensor cores
        "source": "NVIDIA H100 data sheet, SXM5, dense",
    },
}


def peaks_for(device_kind):
    """The PEAKS row of a device; KeyError (never a default) otherwise."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; add a row with its source to "
                       f"tools/roofline.py PEAKS")
    return PEAKS[device_kind]


# Ops that alias or allocate nothing (no memory traffic of their own).
NO_TRAFFIC = {
    "tuple", "get-tuple-element", "bitcast", "parameter", "constant",
    "after-all", "partition-id", "replica-id",
}
# Control-flow ops whose traffic lives in their bodies.
CONTROL = {"while", "conditional", "call", "fusion_call"}

INSTR_RE = re.compile(r"^\s+(ROOT\s+)?%?([\w.-]+)\s+=\s+(.*)$")
NAME_RE = re.compile(r"%([\w.-]+)")
BODY_RE = re.compile(r"body=%?([\w.-]+)")
_OPC_AFTER_TYPE = re.compile(r"\s*([\w-]+)\(")


def split_type_opcode(rhs):
    """(type_str, opcode) from an instruction RHS `TYPE opcode(args), ...`.

    Tuple types are parenthesized and contain nested parens and spaces,
    so a simple regex can't split them — scan to the balanced close paren
    instead. Non-tuple type tokens never contain spaces."""
    if rhs.startswith("("):
        depth = 0
        for i, c in enumerate(rhs):
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
                if depth == 0:
                    m = _OPC_AFTER_TYPE.match(rhs, i + 1)
                    return rhs[:i + 1], (m.group(1) if m else "unknown")
        return rhs, "unknown"
    parts = rhs.split(None, 1)
    if len(parts) == 2:
        m = _OPC_AFTER_TYPE.match(parts[1])
        if m:
            return parts[0], m.group(1)
    return rhs, "unknown"


def shape_bytes(type_str):
    """Logical bytes of every shape literal in `type_str` (tuple types
    sum)."""
    total = 0
    for m in SHAPE_RE.finditer(type_str):
        dt, dims_s, _mtm_s = m.groups()
        dims = [int(x) for x in dims_s.split(",") if x] if dims_s else []
        total += logical_bytes(dt, dims)
    return total


def parse_computations(text):
    """{comp_name: [(instr_name, opcode, result_bytes, rhs), ...]}"""
    comps = {}
    cur = None
    for line in text.splitlines():
        if line and not line[0].isspace():
            # computation header: `%name (params) -> type {` or `ENTRY ...`
            m = re.match(r"(?:ENTRY\s+)?%?([\w.-]+)\s*\(", line)
            if m and "{" in line:
                cur = m.group(1)
                comps[cur] = []
                if line.startswith("ENTRY"):
                    comps["__entry__"] = comps[cur]
            continue
        if cur is None:
            continue
        im = INSTR_RE.match(line)
        if not im:
            continue
        is_root, name, rhs = bool(im.group(1)), im.group(2), im.group(3)
        type_part, opcode = split_type_opcode(rhs)
        comps[cur].append((name, opcode, shape_bytes(type_part), rhs,
                           is_root))
    return comps


CALLS_RE = re.compile(r"calls=%?([\w.-]+)")
# In-place / windowed ops: traffic is the slice region, not the full
# operand (XLA aliases DUS in place; slice/dynamic-slice/gather DMA the
# window only).
SLICED = {"dynamic-update-slice", "dynamic-slice", "gather", "scatter",
          "slice"}


def _fusion_root(rhs, comps):
    """(opcode, rhs) of the ROOT instruction of a fusion's called
    computation, or (None, None)."""
    cm = CALLS_RE.search(rhs)
    body = comps.get(cm.group(1)) if cm else None
    if not body:
        return None, None
    for name, opcode, out_b, brhs, is_root in body:
        if is_root:
            return opcode, brhs
    return body[-1][1], body[-1][3]


def _sliced_traffic(opcode, rhs, out_b, result_bytes_of):
    """Approximate traffic of an in-place/windowed op: 2x the moved
    region (read + write), not the full aliased buffer.

    dynamic-update-slice: region = update operand (2nd arg);
    dynamic-slice/gather: region = the (small) result;
    scatter: region = updates operand (3rd arg, approximated as result
    when lookup fails). Small index operands are ignored."""
    if opcode == "dynamic-update-slice":
        args = rhs.split("(", 1)[1] if "(" in rhs else ""
        names = NAME_RE.findall(args)
        if len(names) >= 2:
            upd = result_bytes_of.get(names[1], 0)
            if upd:
                return 2 * upd
    return 2 * out_b


def computation_traffic(instrs, result_bytes_of, comps):
    """(total_bytes, [(bytes, name, opcode)]) over top-level instructions."""
    rows = []
    for name, opcode, out_b, rhs, _root in instrs:
        if opcode in NO_TRAFFIC or opcode in CONTROL:
            continue
        if opcode in SLICED:
            rows.append((_sliced_traffic(opcode, rhs, out_b,
                                         result_bytes_of), name, opcode))
            continue
        if opcode == "fusion":
            ropc, rrhs = _fusion_root(rhs, comps)
            if ropc in SLICED:
                rows.append((_sliced_traffic(ropc, rrhs, out_b,
                                             result_bytes_of),
                             name, f"fusion:{ropc}"))
                continue
        # operand reads: names referenced in the argument list that are
        # materialized instructions of some computation
        args = rhs.split("(", 1)[1] if "(" in rhs else ""
        in_b = 0
        seen = set()
        for om in NAME_RE.finditer(args):
            on = om.group(1)
            if on in seen:
                continue
            seen.add(on)
            in_b += result_bytes_of.get(on, 0)
        rows.append((out_b + in_b, name, opcode))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows


# ---------------------------------------------------------------------------
# FLOPs side: estimate compute per while iteration so the "compute-bound"
# half of a verdict is arithmetic too.
#
# Unlike memory traffic, FLOPs happen INSIDE fusions, so this walks every
# computation reachable from the body (fusion/call bodies included) and
# buckets work by execution unit:
#   dot           dot/einsum contractions and cuBLAS gemm custom-calls
#                 (tensor cores)
#   conv          dense convolutions (cuDNN)
#   grouped_conv  feature_group_count>1 convolutions — far off the
#                 tensor-core peak, so they get their own bucket and
#                 their own effective ceiling
#   elementwise   everything elementwise/reduce (1 FLOP per output elem;
#                 transcendentals are undercounted on purpose — the
#                 verdicts only need the order of magnitude)
# Nested `while` bodies are counted ONCE per outer iteration (their trip
# counts are dynamic in HLO); the tool lists them so the reader can scale
# by the known trip count (e.g. Newton-Schulz iterations) by hand.
# ---------------------------------------------------------------------------

def shape_elems(type_str):
    """UNPADDED element count of the first shape literal (FLOPs are done
    on logical elements; padding costs bytes, not math)."""
    m = SHAPE_RE.search(type_str)
    if not m:
        return 0
    dims_s = m.group(2)
    dims = [int(x) for x in dims_s.split(",") if x] if dims_s else []
    out = 1
    for d in dims:
        out *= d
    return out


def shape_dims(type_str):
    m = SHAPE_RE.search(type_str)
    if not m:
        return []
    dims_s = m.group(2)
    return [int(x) for x in dims_s.split(",") if x] if dims_s else []


_DIMSET_RE = {k: re.compile(k + r"=\{([\d,]*)\}") for k in
              ("lhs_contracting_dims", "rhs_contracting_dims",
               "lhs_batch_dims", "rhs_batch_dims")}
_WINDOW_SIZE_RE = re.compile(r"window=\{[^}]*size=([\dx]+)")
_LHS_DILATE_RE = re.compile(r"window=\{[^}]*lhs_dilate=([\dx]+)")
_FGC_RE = re.compile(r"feature_group_count=(\d+)")
_DIM_LABELS_RE = re.compile(r"dim_labels=([\w?]+)_([\w?]+)->")

ELEMWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "compare", "select", "and", "or", "xor", "not", "negate", "abs",
    "sign", "floor", "ceil", "round-nearest-even", "round-nearest-afz",
    "exponential", "exponential-minus-one", "log", "log-plus-one",
    "tanh", "sqrt", "rsqrt", "cbrt", "power", "sine", "cosine", "tan",
    "atan2", "erf", "logistic", "expm1", "log1p", "clamp", "remainder",
    "shift-left", "shift-right-logical", "shift-right-arithmetic",
    "is-finite", "popcnt", "clz",
}
NO_FLOPS = NO_TRAFFIC | {
    "copy", "copy-start", "copy-done", "transpose", "broadcast",
    "reshape", "concatenate", "slice", "dynamic-slice",
    "dynamic-update-slice", "gather", "scatter", "pad", "reverse",
    "iota", "convert", "bitcast-convert", "reduce-precision", "rng",
    "rng-bit-generator", "rng-get-and-update-state", "all-gather",
    "all-reduce", "reduce-scatter", "collective-permute", "send",
    "recv", "infeed", "outfeed", "sort", "optimization-barrier",
    "get-dimension-size", "select-and-scatter", "domain", "map",
}

def _operand_names(rhs):
    """Operand names of an instruction RHS, in order. The type prefix can
    itself contain parens (tuple types), so strip it
    with the balanced-paren splitter before finding the argument list."""
    type_part, _ = split_type_opcode(rhs)
    tail = rhs[len(type_part):].split("(", 1)
    if len(tail) < 2:
        return []
    # scan to the balanced close paren of the argument list
    depth, buf = 1, ""
    for c in tail[1]:
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                break
        buf += c
    return NAME_RE.findall(buf)


def _dot_flops(rhs, result_dims):
    ops = _operand_names(rhs)
    if len(ops) < 2:
        return 0
    lhs = result_dims.get(ops[0], [])
    rhs_d = result_dims.get(ops[1], [])
    rc = _DIMSET_RE["rhs_contracting_dims"].search(rhs)
    rb = _DIMSET_RE["rhs_batch_dims"].search(rhs)
    rc = {int(x) for x in rc.group(1).split(",") if x} if rc else set()
    rb = {int(x) for x in rb.group(1).split(",") if x} if rb else set()
    lhs_elems = 1
    for d in lhs:
        lhs_elems *= d
    n = 1
    for i, d in enumerate(rhs_d):
        if i not in rc and i not in rb:
            n *= d
    return 2 * lhs_elems * n


def _gemm_flops(rhs, result_dims):
    """FLOPs of a cuBLAS gemm custom-call: its dot dimension numbers live
    in the backend_config JSON (`"lhs_contracting_dimensions":["1"]`)."""
    ops = _operand_names(rhs)
    if len(ops) < 2:
        return 0
    lhs = result_dims.get(ops[0], [])
    rhs_d = result_dims.get(ops[1], [])

    def dims(key):
        m = re.search(r'"%s":\[([^\]]*)\]' % key, rhs)
        return {int(x) for x in re.findall(r"\d+", m.group(1))} if m \
            else set()
    rc = dims("rhs_contracting_dimensions")
    rb = dims("rhs_batch_dimensions")
    lhs_elems = 1
    for d in lhs:
        lhs_elems *= d
    n = 1
    for i, d in enumerate(rhs_d):
        if i not in rc and i not in rb:
            n *= d
    return 2 * lhs_elems * n


def _conv_flops(rhs, out_dims, result_dims):
    """2 * out_elems * (kernel_elems / out_features), scaled by the
    fraction of kernel taps that land on REAL input elements. The HLO
    kernel's `i` dim is already per-group, so grouping is handled
    implicitly.

    The tap fraction matters for convolutions with `lhs_dilate=B size=B
    stride=B-1` (a batched matmul written as a convolution): the input is
    dilated B-fold with zeros, so of the `size` taps per output only
    ceil(size/lhs_dilate) touch data — counting the full window
    overcounts FLOPs by ~B x."""
    ops = _operand_names(rhs)
    if len(ops) < 2:
        return 0, 1
    ker = result_dims.get(ops[1], [])
    lm = _DIM_LABELS_RE.search(rhs)
    out_elems = 1
    for d in out_dims:
        out_elems *= d
    ker_elems = 1
    for d in ker:
        ker_elems *= d
    o = 1
    if lm and ker:
        kl = lm.group(2)
        if "o" in kl and len(kl) == len(ker):
            o = ker[kl.index("o")]
    sm = _WINDOW_SIZE_RE.search(rhs)
    dm = _LHS_DILATE_RE.search(rhs)
    eff = 1.0
    if sm:
        sizes = [int(x) for x in sm.group(1).split("x")]
        dil = [int(x) for x in dm.group(1).split("x")] if dm else \
            [1] * len(sizes)
        if len(dil) < len(sizes):
            dil += [1] * (len(sizes) - len(dil))
        for s, d in zip(sizes, dil):
            eff *= -(-s // d) / s        # ceil(s/d) of s taps are real
    fm = _FGC_RE.search(rhs)
    groups = int(fm.group(1)) if fm else 1
    return int(2 * out_elems * (ker_elems // max(o, 1)) * eff), groups


def computation_flops(comp_name, comps, result_dims, _seen_whiles=None):
    """{bucket: flops} over `comp_name`, descending into fusion/call
    bodies; nested whiles counted once and recorded in the 'while:*'
    diagnostic keys."""
    if _seen_whiles is None:
        _seen_whiles = []
    out = {"dot": 0, "conv": 0, "grouped_conv": 0, "elementwise": 0}
    for name, opcode, _b, rhs, _root in comps.get(comp_name, []):
        type_part, _ = split_type_opcode(rhs)
        out_elems = shape_elems(type_part)
        if opcode == "dot":
            out["dot"] += _dot_flops(rhs, result_dims)
        elif opcode == "custom-call" and "__cublas" in rhs:
            out["dot"] += _gemm_flops(rhs, result_dims)
        elif opcode == "convolution" or (
                opcode == "custom-call" and "__cudnn$conv" in rhs):
            f, groups = _conv_flops(rhs, shape_dims(type_part),
                                    result_dims)
            out["grouped_conv" if groups > 1 else "conv"] += f
        elif opcode in ("fusion", "call", "async-start"):
            cm = CALLS_RE.search(rhs)
            if cm and cm.group(1) in comps:
                sub = computation_flops(cm.group(1), comps, result_dims,
                                        _seen_whiles)
                for k in out:
                    out[k] += sub[k]
        elif opcode == "while":
            bm = BODY_RE.search(rhs)
            if bm and bm.group(1) in comps:
                _seen_whiles.append(bm.group(1))
                sub = computation_flops(bm.group(1), comps, result_dims,
                                        _seen_whiles)
                for k in out:
                    out[k] += sub[k]
        elif opcode == "reduce":
            ops = _operand_names(rhs)
            in_elems = 1
            for d in result_dims.get(ops[0], []) if ops else []:
                in_elems *= d
            out["elementwise"] += in_elems
        elif opcode == "reduce-window":
            wm = _WINDOW_SIZE_RE.search(rhs)
            win = 1
            if wm:
                for x in wm.group(1).split("x"):
                    win *= int(x)
            out["elementwise"] += out_elems * win
        elif opcode in ELEMWISE:
            out["elementwise"] += out_elems
        # NO_FLOPS and anything unrecognized: data movement, 0 math.
    out["nested_whiles"] = _seen_whiles
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dump")
    ap.add_argument("--device-kind", required=True,
                    help="jax.devices()[0].device_kind of the run (a key "
                         "of PEAKS)")
    ap.add_argument("--batch", type=int, required=True,
                    help="filter instances per while iteration (BENCH_BATCH"
                         " / BENCH_PIXB)")
    ap.add_argument("--steps-per-sec", type=float, default=0.0,
                    help="measured bench steps/s for the achieved-BW line")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--flops", action="store_true",
                    help="also estimate FLOPs per step and position the "
                         "measured rate against the per-unit peaks")
    ap.add_argument("--dot-precision", choices=("bf16", "tf32", "fp32"),
                    default="fp32",
                    help="which peak bounds the dots: tensor-core bf16 or "
                         "TF32, or fp32 outside the tensor cores")
    ap.add_argument("--grouped-eff", type=float, default=0.01,
                    help="achievable fraction of the dot peak for grouped "
                         "convolutions")
    args = ap.parse_args()
    pk = peaks_for(args.device_kind)
    hbm = pk["hbm_bytes_per_s"]

    text = open(args.dump).read()
    comps = parse_computations(text)
    entry = comps.get("__entry__", [])

    # instruction name -> result bytes, across all computations (names are
    # globally unique in HLO text; computation names never collide with
    # instruction names for lookups that matter).
    result_bytes = {}
    for instrs in comps.values():
        for name, opcode, out_b, _rhs, _root in instrs:
            result_bytes[name] = out_b

    # The sequence scan = the while in ENTRY with the biggest body traffic.
    bodies = []
    for name, opcode, out_b, rhs, _root in entry:
        if opcode == "while":
            bm = BODY_RE.search(rhs)
            if bm and bm.group(1) in comps:
                bodies.append(bm.group(1))
    if not bodies:
        sys.exit("no while loop found in ENTRY — is this a sequence dump?")
    body_rows = [(computation_traffic(comps[b], result_bytes, comps), b)
                 for b in bodies]
    (body_bytes, rows), body_name = max(body_rows)

    entry_bytes, _ = computation_traffic(entry, result_bytes, comps)
    per_step = body_bytes / args.batch

    print(f"device: {args.device_kind} (peaks: {pk['source']})")
    print(f"while body: %{body_name} "
          f"({len(comps[body_name])} top-level instructions)")
    print(f"memory traffic per while iteration: {body_bytes / 1e6:.1f} MB "
          f"(entry setup, once per program: {entry_bytes / 1e6:.1f} MB)")
    print(f"bytes per SLAM step (iteration / batch {args.batch}): "
          f"{per_step / 1e3:.1f} KB")
    ceiling = hbm / per_step
    print(f"memory-bound ceiling at {hbm / 1e12:.2f} TB/s: "
          f"{ceiling:,.0f} steps/s")
    if args.steps_per_sec:
        bw = args.steps_per_sec * per_step
        print(f"measured {args.steps_per_sec:,.0f} steps/s -> achieved "
              f"{bw / 1e9:.0f} GB/s = {100 * bw / hbm:.0f}% of the "
              f"published bandwidth")
    print(f"\ntop {args.top} traffic contributors per iteration "
          f"(read+write):")
    for b, name, opcode in rows[:args.top]:
        print(f"  {b / 1e6:9.2f} MB  {opcode:<22} %{name}")

    if args.flops:
        result_dims = {}
        for instrs in comps.values():
            for name, _opc, _b, rhs, _root in instrs:
                tp, _ = split_type_opcode(rhs)
                result_dims[name] = shape_dims(tp)
        fl = computation_flops(body_name, comps, result_dims)
        nested = fl.pop("nested_whiles")
        per_step_fl = {k: v / args.batch for k, v in fl.items()}
        total = sum(per_step_fl.values())
        print(f"\nFLOPs per SLAM step (iteration / batch {args.batch}):")
        for k, v in sorted(per_step_fl.items(), key=lambda kv: -kv[1]):
            print(f"  {v / 1e6:10.2f} MFLOP  {k}")
        print(f"  {total / 1e6:10.2f} MFLOP  total")
        if nested:
            print(f"  note: {len(nested)} nested while bodies counted "
                  f"ONCE each (dynamic trip counts): "
                  f"{sorted(set(nested))[:4]}")
        if args.steps_per_sec:
            dot_peak = pk[f"{args.dot_precision}_flops"]
            peaks = {"dot": dot_peak, "conv": dot_peak,
                     "grouped_conv": dot_peak * args.grouped_eff,
                     "elementwise": pk["fp32_flops"]}
            print("achieved vs per-unit peaks at "
                  f"{args.steps_per_sec:,.0f} steps/s:")
            t_total = 0.0
            for k, v in sorted(per_step_fl.items(), key=lambda kv: -kv[1]):
                rate = v * args.steps_per_sec
                t_unit = v / peaks[k] if peaks[k] else 0.0
                t_total += t_unit
                print(f"  {k:<13} {rate / 1e12:8.4f} TFLOP/s = "
                      f"{100 * rate / peaks[k]:6.1f}% of its "
                      f"{peaks[k] / 1e12:.2f} TFLOP/s ceiling "
                      f"(min time {t_unit * 1e6:.1f} us/step)")
            ceiling_c = 1.0 / t_total if t_total else float("inf")
            print(f"  compute-bound ceiling (sum of per-unit min times): "
                  f"{ceiling_c:,.0f} steps/s -> measured is "
                  f"{100 * args.steps_per_sec / ceiling_c:.0f}% of it")


if __name__ == "__main__":
    main()
