"""Contract tests for the HLO roofline parser (tools/roofline.py), on
GPU-style compiled HLO text (plain `{1,0}` layouts, cuBLAS gemm
custom-calls, async collectives):

  - tuple-typed instructions (`(f32[...], s8[...]) custom-call(...)`)
    must split into (type, opcode) despite nested parens/spaces;
  - shapes count at their logical size (the GPU pads nothing);
  - library custom-calls (cuBLAS gemm) move their operands and result
    like any kernel and count as traffic;
  - windowed/in-place ops (dynamic-update-slice, dynamic-slice, and
    fusions whose ROOT is one) count 2x the moved REGION, not the full
    aliased operand — XLA aliases DUS in place;
  - operand re-reads by one instruction are deduped per unique name;
  - peaks come from the device_kind table; an unknown device is an error.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import roofline  # noqa: E402


def test_split_type_opcode_tuple_type():
    t, opc = roofline.split_type_opcode(
        "(f32[64,613]{1,0}, s8[4194304]{0}) custom-call(%a, %b), "
        'custom_call_target="__cublas$gemm"')
    assert t == "(f32[64,613]{1,0}, s8[4194304]{0})"
    assert opc == "custom-call"


def test_split_type_opcode_plain():
    t, opc = roofline.split_type_opcode(
        "f32[3,5]{1,0} add(%x, %y), metadata={}")
    assert t == "f32[3,5]{1,0}"
    assert opc == "add"


def test_shape_bytes_logical():
    assert roofline.shape_bytes("f32[3,5]{1,0}") == 3 * 5 * 4
    assert roofline.shape_bytes("f32[64,613]{1,0}") == 64 * 613 * 4
    assert roofline.shape_bytes("bf16[64,613]{1,0}") == 64 * 613 * 2
    # Tuple types sum their members.
    both = "(f32[8,128]{1,0}, pred[3]{0}) tuple(%a, %b)"
    t, _ = roofline.split_type_opcode(both)
    assert roofline.shape_bytes(t) == 8 * 128 * 4 + 3


def test_peaks_table_keyed_by_device_kind():
    pk = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert pk["hbm_bytes_per_s"] == 3.35e12 and "source" in pk
    with pytest.raises(KeyError):
        roofline.peaks_for("Some Other Accelerator")
    with pytest.raises(KeyError):
        roofline.peaks_for("cpu")


# A miniature compiled-HLO dump in the `compiled.as_text()` grammar: one
# fused DUS computation, a cuBLAS gemm, a while body, and an ENTRY.
MINI_DUMP = """\
HloModule mini

%fused_dus (p1.0: f32[64,613], u1.0: f32[2,613]) -> f32[64,613] {
  %p1 = f32[64,613]{1,0} parameter(0)
  %u1 = f32[2,613]{1,0} parameter(1)
  %c1 = s32[] constant(7)
  ROOT %dus.inner = f32[64,613]{1,0} dynamic-update-slice(%p1, %u1, %c1, %c1)
}

%cond.1 (carry.0: (f32[64,613], s32[])) -> pred[] {
  %carry.0 = (f32[64,613]{1,0}, s32[]) parameter(0)
  ROOT %lt = pred[] constant(true)
}

%body.1 (carry.1: (f32[64,613], s32[])) -> (f32[64,613], s32[]) {
  %carry = (f32[64,613]{1,0}, s32[]) parameter(0)
  %P = f32[64,613]{1,0} get-tuple-element(%carry), index=0
  %i = s32[] get-tuple-element(%carry), index=1
  %Q = f32[64,613]{1,0} add(%P, %P)
  %c0 = s32[] constant(0)
  %win = f32[3,5]{1,0} dynamic-slice(%Q, %c0, %c0), dynamic_slice_sizes={3,5}
  %upd = f32[2,613]{1,0} multiply(%win, %win)
  %newP = f32[64,613]{1,0} fusion(%Q, %upd), kind=kLoop, calls=%fused_dus
  %gemm = (f32[64,64]{1,0}, s8[1024]{0}) custom-call(%newP, %newP), custom_call_target="__cublas$gemm", backend_config={"gemm_backend_config":{"dot_dimension_numbers":{"lhs_contracting_dimensions":["1"],"rhs_contracting_dimensions":["1"],"lhs_batch_dimensions":[],"rhs_batch_dimensions":[]}}}
  ROOT %out = (f32[64,613]{1,0}, s32[]) tuple(%newP, %i)
}

ENTRY %main.2 (p0.0: f32[64,613]) -> (f32[64,613], s32[]) {
  %p0 = f32[64,613]{1,0} parameter(0)
  %i0 = s32[] constant(0)
  %init = (f32[64,613]{1,0}, s32[]) tuple(%p0, %i0)
  ROOT %while.3 = (f32[64,613]{1,0}, s32[]) while(%init), condition=%cond.1, body=%body.1
}
"""

P_BYTES = 64 * 613 * 4
WIN_BYTES = 3 * 5 * 4
UPD_BYTES = 2 * 613 * 4
GEMM_OUT = 64 * 64 * 4 + 1024


def _body_rows(dump=MINI_DUMP):
    comps = roofline.parse_computations(dump)
    result_bytes = {n: b for instrs in comps.values()
                    for n, _o, b, _r, _rt in instrs}
    return comps, roofline.computation_traffic(
        comps["body.1"], result_bytes, comps)


def test_mini_dump_body_traffic():
    comps, (total, rows) = _body_rows()
    assert "__entry__" in comps and "body.1" in comps
    by = {name: b for b, name, _opc in rows}
    # add: write P + ONE read of %P (dedup of the repeated operand).
    assert by["Q"] == 2 * P_BYTES
    # dynamic-slice: 2x the window, NOT the full f32[64,613] operand.
    assert by["win"] == 2 * WIN_BYTES
    # plain elementwise: write + materialized-operand reads.
    assert by["upd"] == UPD_BYTES + WIN_BYTES
    # fusion rooted at DUS: 2x the update region (%u1 = f32[2,613]).
    assert by["newP"] == 2 * UPD_BYTES
    # parameter / get-tuple-element / constant / tuple move nothing.
    assert set(by) == {"Q", "win", "upd", "newP", "gemm"}
    assert total == sum(by.values())


def test_cublas_custom_call_counts_as_traffic():
    _, (_, rows) = _body_rows()
    by = {name: b for b, name, _opc in rows}
    # result tuple (output + workspace) + ONE read of the deduped operand
    assert by["gemm"] == GEMM_OUT + P_BYTES


def test_mini_dump_fusion_labeled_as_dus():
    _, (_, rows) = _body_rows()
    opc = {name: o for _b, name, o in rows}
    assert opc["newP"] == "fusion:dynamic-update-slice"
    assert opc["gemm"] == "custom-call"


# FLOPs-side contract: dot and cuBLAS gemm contraction math, dense vs
# grouped convolution bucketing, fusion-internal elementwise work, and
# the tuple-type operand-extraction pitfall.
FLOPS_DUMP = """\
HloModule flops

%fused_ew (a.0: f32[8,16], b.0: f32[8,16]) -> f32[8,16] {
  %a0 = f32[8,16]{1,0} parameter(0)
  %b0 = f32[8,16]{1,0} parameter(1)
  %m = f32[8,16]{1,0} multiply(%a0, %b0)
  ROOT %e = f32[8,16]{1,0} exponential(%m)
}

%cond.f (c.0: (f32[4,6], s32[])) -> pred[] {
  %c.0 = (f32[4,6]{1,0}, s32[]) parameter(0)
  ROOT %lt = pred[] constant(true)
}

%body.f (c.1: (f32[4,6], s32[])) -> (f32[4,6], s32[]) {
  %cr = (f32[4,6]{1,0}, s32[]) parameter(0)
  %A = f32[4,6]{1,0} get-tuple-element(%cr), index=0
  %i = s32[] get-tuple-element(%cr), index=1
  %B = f32[6,5]{1,0} broadcast(%A), dimensions={}
  %D = f32[4,5]{1,0} dot(%A, %B), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %G = (f32[4,5]{1,0}, s8[64]{0}) custom-call(%A, %B), custom_call_target="__cublas$gemm", backend_config={"gemm_backend_config":{"dot_dimension_numbers":{"lhs_contracting_dimensions":["1"],"rhs_contracting_dimensions":["0"],"lhs_batch_dimensions":[],"rhs_batch_dimensions":[]}}}
  %img = f32[1,10,12,4]{3,2,1,0} broadcast(%A), dimensions={}
  %ker = f32[3,3,4,8]{3,2,1,0} broadcast(%A), dimensions={}
  %cv = f32[1,10,12,8]{3,2,1,0} convolution(%img, %ker), window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f
  %kerg = f32[3,3,1,4]{3,2,1,0} broadcast(%A), dimensions={}
  %cg = f32[1,10,12,4]{3,2,1,0} convolution(%img, %kerg), window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f, feature_group_count=4
  %x1 = f32[8,16]{1,0} broadcast(%A), dimensions={}
  %fe = f32[8,16]{1,0} fusion(%x1, %x1), kind=kLoop, calls=%fused_ew
  %c0f = f32[] constant(0)
  %rd = f32[4]{0} reduce(%A, %c0f), dimensions={1}, to_apply=%fused_ew
  ROOT %o = (f32[4,6]{1,0}, s32[]) tuple(%A, %i)
}

ENTRY %main.f (p.0: f32[4,6]) -> (f32[4,6], s32[]) {
  %p0 = f32[4,6]{1,0} parameter(0)
  %i0 = s32[] constant(0)
  %in = (f32[4,6]{1,0}, s32[]) tuple(%p0, %i0)
  ROOT %w = (f32[4,6]{1,0}, s32[]) while(%in), condition=%cond.f, body=%body.f
}
"""


def _flops_of(dump, body):
    comps = roofline.parse_computations(dump)
    result_dims = {}
    for instrs in comps.values():
        for name, _o, _b, rhs, _rt in instrs:
            tp, _ = roofline.split_type_opcode(rhs)
            result_dims[name] = roofline.shape_dims(tp)
    return roofline.computation_flops(body, comps, result_dims)


def test_flops_buckets():
    fl = _flops_of(FLOPS_DUMP, "body.f")
    # dot f32[4,6] x f32[6,5]: 2*4*6*5, plus the same shape as a gemm
    assert fl["dot"] == 2 * (2 * 4 * 6 * 5)
    # dense conv: 2 * out(1*10*12*8) * (3*3*4)
    assert fl["conv"] == 2 * (10 * 12 * 8) * (3 * 3 * 4)
    # grouped conv (fgc=4, kernel i-dim already per-group = 1):
    # 2 * out(1*10*12*4) * (3*3*1)
    assert fl["grouped_conv"] == 2 * (10 * 12 * 4) * (3 * 3 * 1)
    # elementwise: fusion body (multiply + exponential = 2 * 8*16) +
    # reduce (input elems 4*6)
    assert fl["elementwise"] == 2 * 8 * 16 + 4 * 6
    assert fl["nested_whiles"] == []


def test_conv_flops_lhs_dilated_batch_matmul():
    # A batched matmul written as a convolution: lhs_dilate=B size=B
    # stride=B-1 means ONE real tap per output, not B.
    result_dims = {"x": [128, 8, 6], "k": [128, 6, 5]}
    f, groups = roofline._conv_flops(
        "f32[128,8,5]{2,1,0} convolution(%x, %k), "
        "window={size=128 stride=127 lhs_dilate=128}, "
        "dim_labels=0bf_0io->0bf",
        [128, 8, 5], result_dims)
    # 2 * out(128*8*5) * i(6) — kernel spatial 128 collapses to 1 tap.
    assert f == 2 * (128 * 8 * 5) * 6
    assert groups == 1


def test_operand_names_skips_type_parens():
    # A tuple result type has parens BEFORE the argument list; operand
    # extraction must not split there.
    names = roofline._operand_names(
        "(f32[4,5]{1,0}, s8[64]{0}) custom-call(%A, %B), "
        'custom_call_target="__cublas$gemm"')
    assert names == ["A", "B"]
