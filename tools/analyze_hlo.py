"""Rank the ops of a compiled HLO dump by buffer size.

Parses `compiled.as_text()` output (e.g. the hlo.txt that
tools/profile_sim.py writes), sums the logical bytes of each op's result
by (dtype, shape, layout, opcode), and prints
the largest groups — where the program materializes its big arrays (full
covariance copies, layout transposes, gathers):

  python tools/analyze_hlo.py /path/to/step.hlo [--top 40] [--min-mb 1]

The GPU keeps arrays unpadded, so these are the bytes the program moves
when it writes the buffer once.
"""

import argparse
import re
from collections import defaultdict

# f32[512,100,2,2]{3,2,1,0}  or  bf16[...]{...}
SHAPE_RE = re.compile(
    r"\b(f64|f32|bf16|f16|s32|u32|s8|u8|pred|s64|u64)"
    r"\[([0-9,]*)\]"
    r"(?:\{([0-9,]+)[^}]*\})?")

BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
         "bf16": 2, "f16": 2, "s8": 1, "u8": 1, "pred": 1}


def logical_bytes(dtype, dims):
    n = BYTES.get(dtype, 4)
    for d in dims:
        n *= d
    return n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("hlo")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--min-mb", type=float, default=1.0)
    args = ap.parse_args()

    agg = defaultdict(lambda: [0.0, 0, ""])  # MB, count, example name
    for line in open(args.hlo):
        line = line.strip()
        if " = " not in line:
            continue
        name, rhs = line.split(" = ", 1)
        m = SHAPE_RE.search(rhs)
        if not m:
            continue
        dt, dims_s, mtm_s = m.groups()
        dims = [int(x) for x in dims_s.split(",") if x] if dims_s else []
        mtm = tuple(int(x) for x in mtm_s.split(",")) if mtm_s else None
        opkind = SHAPE_RE.sub("", rhs, count=1).strip().split("(")[0]
        ent = agg[(dt, tuple(dims), mtm, opkind)]
        ent[0] += logical_bytes(dt, dims) / 1e6
        ent[1] += 1
        ent[2] = name.strip()
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    print(f"TOTAL {sum(v[0] for v in agg.values()):.0f} MB of op results")
    print(f"{'MB':>9} {'n':>4}  shape/layout/op")
    for (dt, dims, mtm, opkind), (mb, n, name) in rows[:args.top]:
        if mb < args.min_mb:
            break
        print(f"{mb:9.1f} {n:4d}  {dt}[{','.join(map(str, dims))}]"
              f"{{{','.join(map(str, mtm)) if mtm else '-'}}} "
              f"{opkind[:40]}  e.g.{name[:40]}")


if __name__ == "__main__":
    main()
