"""VSS — Variational Semantic Segmentator (the CALC2 network) in Flax.

Behavior source: "CALC 2.0"/calc2.py:125-243 (`vss()`), re-designed for
an accelerator:

* Encoder (calc2.py:147-171): a 32-ch 3x3 conv, two 16->32 bottleneck
  residual pairs, then (64,64)/(128,128)/(256,256)/(512,512) conv pairs with
  2x2 max-pool between stages — ELU + BatchNorm on every conv, 'SAME'
  padding, NHWC.
* Latent heads (calc2.py:176-214): `mu` and `log_sig_sq` are plain 3x3 convs
  (no norm/activation) to 4*(1+13)=56 channels; z = mu + sqrt(exp(s))*eps.
* Descriptor (calc2.py:186-195): residual against a trainable center grid
  (NetVLAD-style `offset` variable), intra-normalize over channels, flatten,
  global L2 normalize.
* Decoders (calc2.py:217-242): the reference builds 14 INDEPENDENT decoder
  towers (one RGB reconstruction + 13 single-class segmentation heads), each
  consuming a 4-channel slice of z through four (conv -> depth_to_space x2
  -> conv -> conv) stages. Running 14 small towers sequentially wastes the
  matmul units; here they are ONE tower of grouped convolutions
  (feature_group_count=14), mathematically the same family — each group has
  private weights and sees only its own z-slice — but launched as single
  large convs. Per-group depth_to_space is a reshape/transpose on the
  group-split channel axis.

Dtype policy: parameters live in float32; activations can run in bfloat16
(`compute_dtype`) for tensor-core throughput, with normalization
statistics and the final heads in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

N_CLASSES = 13  # CALC class table size ("CALC 2.0"/dataset/coco_classes.py)
N_HEADS = 1 + N_CLASSES            # RGB reconstruction + per-class seg
LATENT_PER_HEAD = 4                # calc2.py:176 — 4*(1+13) latent channels


@dataclasses.dataclass(frozen=True)
class VSSConfig:
    num_classes: int = N_CLASSES
    width: int = 32                 # encoder base width
    compute_dtype: str = "float32"  # "bfloat16" for the fast path
    bn_momentum: float = 0.9997     # calc2.py:133 decay
    bn_epsilon: float = 1e-5
    # Rematerialize each conv block in the backward pass (nn.remat —
    # a lifted transform, so the parameter tree is unchanged). Trades
    # ~1/3 extra forward FLOPs for dropping the BN/ELU intermediates
    # from the gradient stash; required to fit the reference training
    # shape (192x256 crop, batch 12, width 32) in 16 GB HBM — without
    # it the train step needs 23.6 GB (runs/r3g/queue.log).
    remat: bool = False
    # Descriptor-head variants for the perceptual-aliasing regime
    # (docs/CALC2_RUN.md r3: sibling places differ in ~2/48 Voronoi
    # cells, and the reference's H/16 NetVLAD-pooled global descriptor
    # compresses same-archetype cosines into a 1e-4 band — a ceiling no
    # training objective recovers). Opt-in, measured variants:
    #   descr_source = "d5"   — reference parity (calc2.py:186-195):
    #                           residual descriptor over the H/16 `mu`.
    #   descr_source = "d4"   — the same residual head over the H/8
    #                           encoder stage (own conv + center grid):
    #                           4x finer cells localize the differing
    #                           content instead of blending it into
    #                           archetype-dominated receptive fields.
    #   descr_source = "multi"— equal-weight concat of the two levels'
    #                           unit-normalized descriptors (cosine =
    #                           mean of the per-level cosines).
    # descr_intra_norm=False drops the per-cell intra-normalization so
    # cells with large residuals (unusual content) dominate the global
    # cosine instead of every cell voting equally.
    # The default config's parameter tree is UNCHANGED by this feature
    # (tests/test_models.py::test_descr_variant_param_tree).
    descr_source: str = "d5"
    descr_intra_norm: bool = True

    @property
    def heads(self) -> int:
        return 1 + self.num_classes

    @property
    def latent_ch(self) -> int:
        return LATENT_PER_HEAD * self.heads


class ConvBNElu(nn.Module):
    """slim.conv2d default stack of the reference: conv + BN + ELU
    (calc2.py:139-146)."""
    features: int
    kernel: Tuple[int, int] = (3, 3)
    cfg: VSSConfig = VSSConfig()

    @nn.compact
    def __call__(self, x, train: bool):
        dt = jnp.dtype(self.cfg.compute_dtype)
        x = nn.Conv(self.features, self.kernel, padding="SAME",
                    use_bias=False, dtype=dt)(x)
        x = nn.BatchNorm(use_running_average=not train,
                         momentum=self.cfg.bn_momentum,
                         epsilon=self.cfg.bn_epsilon,
                         dtype=jnp.float32)(x)
        return nn.elu(x).astype(dt)


def _pool(x):
    return nn.max_pool(x, (2, 2), strides=(2, 2), padding="SAME")


def _remat(block_cls):
    """nn.remat'd conv block with the ORIGINAL auto-naming (flax derives
    default module names from the class __name__; the lifted transform's
    "Checkpoint<cls>" default would fork the parameter tree and break
    checkpoint compatibility between remat on/off —
    tests/test_models.py::test_remat_bit_equivalent)."""
    cls = nn.remat(block_cls, static_argnums=(2,))
    cls.__name__ = block_cls.__name__
    return cls


class Encoder(nn.Module):
    cfg: VSSConfig

    @nn.compact
    def __call__(self, x, train: bool):
        c = self.cfg
        w = c.width
        Block = _remat(ConvBNElu) if c.remat else ConvBNElu
        conv = lambda f, k=(3, 3): Block(f, k, c)
        r1 = conv(w)(x, train)
        r3 = conv(w)(conv(w // 2, (1, 1))(r1, train), train) + r1
        r5 = conv(w)(conv(w // 2, (1, 1))(r3, train), train) + r3
        p1 = _pool(r5)
        d2 = conv(2 * w)(conv(2 * w)(p1, train), train)
        p2 = _pool(d2)
        d3 = conv(4 * w)(conv(4 * w)(p2, train), train)
        p3 = _pool(d3)
        d4 = conv(8 * w)(conv(8 * w)(p3, train), train)
        p4 = _pool(d4)
        d5 = conv(16 * w)(conv(16 * w)(p4, train), train)
        # r5 = "c5" low-level features for kp_descriptor; d4 (H/8) feeds
        # the finer-latent descriptor variants (VSSConfig.descr_source).
        return d5, r5, d4


class GroupedConvBNElu(nn.Module):
    """feature_group_count=heads conv + per-group BN + ELU — the fused form
    of the reference's 14 independent decoder convs (calc2.py:218-236)."""
    features_per_group: int
    heads: int
    cfg: VSSConfig

    @nn.compact
    def __call__(self, x, train: bool):
        dt = jnp.dtype(self.cfg.compute_dtype)
        x = nn.Conv(self.features_per_group * self.heads, (3, 3),
                    padding="SAME", use_bias=False,
                    feature_group_count=self.heads, dtype=dt)(x)
        x = nn.BatchNorm(use_running_average=not train,
                         momentum=self.cfg.bn_momentum,
                         epsilon=self.cfg.bn_epsilon,
                         dtype=jnp.float32)(x)
        return nn.elu(x).astype(dt)


import os as _os

# Grouped depth_to_space lowering (A/B knob, bit-identical outputs —
# tests/test_models.py::test_d2s_convt_bit_equals_reshape):
#   "convt"   — stride-r conv_transpose against a CONSTANT one-hot
#               kernel: the spatial interleave runs as a matmul and
#               every tensor stays big-channel NHWC. The reshape form's
#               7-D transpose materializes temps whose two minor dims
#               are (r, c_out) — small minor dims that tiled layouts
#               pad many-fold at the reference training scale.
#   "reshape" — the plain reshape/transpose pair.
_D2S = _os.environ.get("VSS_D2S", "convt")


def grouped_depth_to_space(x: jnp.ndarray, heads: int, r: int = 2):
    """depth_to_space applied within each of `heads` channel groups.

    x: (B, H, W, heads*C) with C divisible by r². Returns
    (B, rH, rW, heads*C/r²). Equivalent to the reference applying
    tf.depth_to_space inside each decoder tower (calc2.py:219-231).
    """
    B, H, W, HC = x.shape
    C = HC // heads
    c_out = C // (r * r)
    if _D2S == "convt":
        # One-hot kernel K[i, j, cin, cout]: input channel
        # (head, i, j, co) routes to output (2h+i, 2w+j, head*c_out+co).
        # Exact selection (0/1 weights, HIGHEST precision), so this is a
        # bit-exact rearrangement, not an approximation.
        cin = jnp.arange(HC)
        head_i = cin // C
        rem = cin % C
        ii, jj = rem // (r * c_out), (rem // c_out) % r
        co = rem % c_out
        kern = ((jnp.arange(r)[:, None, None, None] == ii[None, None, :,
                                                          None])
                & (jnp.arange(r)[None, :, None, None] == jj[None, None, :,
                                                            None])
                & (jnp.arange(heads * c_out)[None, None, None, :]
                   == (head_i * c_out + co)[None, None, :, None]))
        # conv_transpose applies the kernel spatially FLIPPED; flip it
        # back so input (i, j) lands at output (r*h+i, r*w+j).
        kern = kern[::-1, ::-1].astype(x.dtype)    # (r, r, HC, heads*c_out)
        return jax.lax.conv_transpose(
            x, kern, strides=(r, r), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)
    x = x.reshape(B, H, W, heads, r, r, c_out)
    x = x.transpose(0, 1, 4, 2, 5, 3, 6)          # B H r W r heads c
    return x.reshape(B, H * r, W * r, heads * c_out)


class Decoder(nn.Module):
    """14 per-head towers as grouped convs; 4 stages of x2 upsampling."""
    cfg: VSSConfig

    @nn.compact
    def __call__(self, z, train: bool):
        c = self.cfg
        h = c.heads
        Block = _remat(GroupedConvBNElu) if c.remat else GroupedConvBNElu
        g = lambda f: Block(f, h, c)
        # stage 1: conv(128) then d2s(2) -> 32/group, conv, conv
        x = g(128)(z, train)
        x = grouped_depth_to_space(x, h)
        x = g(128)(x, train)
        x = g(128)(x, train)
        # stage 2
        x = grouped_depth_to_space(x, h)
        x = g(64)(x, train)
        x = g(64)(x, train)
        x = g(64)(x, train)
        # stage 3
        x = grouped_depth_to_space(x, h)
        x = g(32)(x, train)
        x = g(32)(x, train)
        x = g(32)(x, train)
        # stage 4
        x = grouped_depth_to_space(x, h)
        x = g(16)(x, train)
        x = g(16)(x, train)
        x = g(16)(x, train)
        # heads: 4 channels per group (1x1 grouped conv, no norm/act) —
        # group 0 channels 0:3 = RGB logits, groups 1.. channel 0 = seg logit
        x = nn.Conv(4 * h, (1, 1), feature_group_count=h,
                    dtype=jnp.float32)(x.astype(jnp.float32))
        B, H, W, _ = x.shape
        x = x.reshape(B, H, W, h, 4)
        rec = nn.sigmoid(x[..., 0, 0:3])
        seg = x[..., 1:, 0]                        # (B, H, W, 13) logits
        return rec, seg


class VSS(nn.Module):
    """Full VSS: returns a dict with descriptor, mu, log_sig_sq, rec, seg,
    z, c5 (mirrors the tuple of calc2.py:243)."""
    cfg: VSSConfig = VSSConfig()

    @nn.compact
    def __call__(self, images, train: bool = False,
                 rng: Optional[jax.Array] = None,
                 descriptor_only: bool = False):
        c = self.cfg
        x = images.astype(jnp.dtype(c.compute_dtype))
        d5, c5, d4 = Encoder(c)(x, train)

        mu = nn.Conv(c.latent_ch, (3, 3), padding="SAME",
                     dtype=jnp.float32, name="mu")(d5.astype(jnp.float32))

        # NetVLAD-style residual descriptor (calc2.py:186-195); the
        # residual grid can come from the H/16 latent (reference), the
        # H/8 stage, or both (VSSConfig.descr_source — aliasing-regime
        # variants, rationale in the config docstring).
        def residual_descr(grid, offset_name):
            centers = self.param(offset_name, nn.initializers.normal(1.0),
                                 (1,) + grid.shape[1:], jnp.float32)
            res = grid - centers
            if c.descr_intra_norm:
                res = res / (jnp.linalg.norm(res, axis=-1, keepdims=True)
                             + 1e-12)
            flat = res.reshape(res.shape[0], -1)
            return flat / (jnp.linalg.norm(flat, axis=-1, keepdims=True)
                           + 1e-12)

        parts = []
        if c.descr_source in ("d5", "multi"):
            parts.append(residual_descr(mu, "offset"))
        if c.descr_source in ("d4", "multi"):
            mu4 = nn.Conv(c.latent_ch, (3, 3), padding="SAME",
                          dtype=jnp.float32,
                          name="mu_d4")(d4.astype(jnp.float32))
            parts.append(residual_descr(mu4, "offset_d4"))
        if not parts:
            raise ValueError(f"unknown descr_source {c.descr_source!r}")
        # Each part is unit-norm; equal-weight concat keeps unit norm and
        # makes the cosine the mean of the per-level cosines.
        descr = (parts[0] if len(parts) == 1
                 else jnp.concatenate(parts, axis=-1)
                 / jnp.sqrt(jnp.float32(len(parts))))
        if descriptor_only:
            return {"descriptor": descr, "c5": c5}

        log_sig_sq = nn.Conv(c.latent_ch, (3, 3), padding="SAME",
                             dtype=jnp.float32,
                             name="log_sig_sq")(d5.astype(jnp.float32))
        if rng is None:
            rng = self.make_rng("reparam")
        eps = jax.random.normal(rng, mu.shape, jnp.float32)
        z = mu + jnp.sqrt(jnp.exp(log_sig_sq)) * eps

        # DOCUMENTED DEVIATION (latent slicing): the reference slices z
        # OVERLAPPINGLY — tower i reads z[:,:,:,i:(i+4)] for i in 0..13
        # (calc2.py:219), so all 14 towers share channels 0..16 and
        # latent channels 17..55 are DEAD (never decoded, trained only
        # through the KL term). Like the keypoint off-by-cell fix
        # (models/keypoints.py:17-20), this looks like an indexing bug —
        # the evident intent of a 4*heads-channel latent is one disjoint
        # 4-channel slice per tower, which is what the grouped decoder
        # implements: group i sees z[..., 4i:4i+4], every latent channel
        # is decoded, and no tower shares latent capacity.
        # tests/test_models.py::test_decoder_group_isolation pins the
        # disjoint routing.
        rec, seg = Decoder(c)(z.astype(jnp.dtype(c.compute_dtype)), train)
        return {"descriptor": descr, "mu": mu, "log_sig_sq": log_sig_sq,
                "rec": rec, "seg": seg, "z": z, "c5": c5}
