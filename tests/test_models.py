"""CALC2-class model tests: shapes, losses, one train step, DP sharding.

Mirrors the reference's implicit correctness signals (SURVEY.md §4): NaN
checks on all four losses (calc2.py:311-313) and loss-goes-down on fixed
seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ekf_slam_tpu.data import class_weights, synthetic_batch
from ekf_slam_tpu.models import augment, losses, train
from ekf_slam_tpu.models.vss import VSS, VSSConfig, grouped_depth_to_space

HW = (32, 32)  # small-but-divisible-by-16 test resolution
CFG = VSSConfig(width=8)  # tiny width: tests run on a single-CPU host


@pytest.fixture(scope="module")
def model_and_state():
    model = train.create_model(CFG)
    tcfg = train.TrainConfig(batch_size=2, image_hw=HW)
    state = train.init_state(model, tcfg, jax.random.key(0))
    return model, tcfg, state


def test_vss_forward_shapes(model_and_state):
    model, tcfg, state = model_and_state
    B, (h, w) = 2, HW
    imgs = jnp.zeros((B, h, w, 3), jnp.float32)
    outs = model.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        imgs, train=False, rngs={"reparam": jax.random.key(1)})
    assert outs["rec"].shape == (B, h, w, 3)
    assert outs["seg"].shape == (B, h, w, 13)
    assert outs["mu"].shape == (B, h // 16, w // 16, 56)
    d = outs["descriptor"]
    assert d.shape == (B, (h // 16) * (w // 16) * 56)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0,
                               rtol=1e-5)


def test_grouped_depth_to_space_matches_per_group():
    x = jax.random.normal(jax.random.key(0), (2, 4, 4, 3 * 8))
    out = grouped_depth_to_space(x, heads=3, r=2)
    assert out.shape == (2, 8, 8, 3 * 2)
    # Group g of the output must depend only on group g of the input.
    x2 = x.at[..., 8:16].set(0.0)   # zero group 1
    out2 = grouped_depth_to_space(x2, heads=3, r=2)
    np.testing.assert_array_equal(np.asarray(out[..., 0:2]),
                                  np.asarray(out2[..., 0:2]))
    np.testing.assert_array_equal(np.asarray(out[..., 4:6]),
                                  np.asarray(out2[..., 4:6]))
    assert np.all(np.asarray(out2[..., 2:4]) == 0)


def test_homography_exact_on_corners():
    src = jnp.array([[[-1., -1.], [-1., 1.], [1., -1.], [1., 1.]]])
    dst = src * 0.8 + 0.05
    H = augment.estimate_hom(src, dst)
    pts = jnp.concatenate([src[0].T, jnp.ones((1, 4))])
    mapped = H[0] @ pts
    mapped = mapped[:2] / mapped[2:]
    np.testing.assert_allclose(np.asarray(mapped.T), np.asarray(dst[0]),
                               atol=1e-5)


def test_hom_warp_identity_gradient():
    """Identity homography under the reference's grid convention
    ([-1,1] -> [0,W], layers.py:56-57 — half-pixel offset included): on a
    linear gradient, bilinear sampling is exact, so the output is the
    analytically shifted/clamped gradient."""
    H_, W_ = 16, 24
    xgrad = jnp.broadcast_to(jnp.arange(W_, dtype=jnp.float32), (H_, W_))
    img = xgrad[None, :, :, None]
    out = augment.hom_warp(img, (H_, W_), jnp.eye(3)[None])
    gx = np.linspace(-1.0, 1.0, W_)
    expected = np.clip((gx + 1.0) * W_ / 2.0, 0, W_ - 1)
    np.testing.assert_allclose(np.asarray(out[0, 3, :, 0]), expected,
                               atol=1e-4)


def test_seasonal_change_severity():
    """severity=0 through eval_view is the pre-existing behavior; the
    seasonal model stays in range, is deterministic per key, and actually
    perturbs the image (gain field + noise + occluders) at severity 1."""
    key = jax.random.key(3)
    imgs = jax.random.uniform(jax.random.key(4), (2, 32, 40, 3))
    out0 = augment.eval_view(key, imgs, severity=0.0)
    out0b = augment.eval_view(key, imgs)
    np.testing.assert_array_equal(np.asarray(out0), np.asarray(out0b))
    out1 = augment.seasonal_change(jax.random.key(5), imgs, severity=1.0)
    a = np.asarray(out1)
    assert a.shape == imgs.shape
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert np.abs(a - np.asarray(imgs)).mean() > 0.02
    out1b = augment.seasonal_change(jax.random.key(5), imgs, severity=1.0)
    np.testing.assert_array_equal(a, np.asarray(out1b))


def test_random_crop_joint_alignment():
    """Image and label crop from the SAME region (the reference crops
    the channel-concatenated pair, calc2.py:254-258); shapes and dtype
    are preserved; shared-offset mode reproduces one offset batch-wide."""
    key = jax.random.key(0)
    B, H, W = 3, 12, 16
    # Encode position into the image so the crop offset is recoverable.
    ys = jnp.broadcast_to(jnp.arange(H, dtype=jnp.float32)[:, None], (H, W))
    xs = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32), (H, W))
    imgs = jnp.stack([jnp.stack([ys, xs, ys * 0], -1)] * B)
    lbl_ids = (ys[None].astype(jnp.int32) * W + xs[None].astype(jnp.int32))
    lbl = jax.nn.one_hot(jnp.broadcast_to(lbl_ids % 13, (B, H, W)), 13)
    ic, lc = augment.random_crop(key, imgs, lbl, (8, 8))
    assert ic.shape == (B, 8, 8, 3) and lc.shape == (B, 8, 8, 13)
    assert lc.dtype == lbl.dtype
    for b in range(B):
        oy = int(ic[b, 0, 0, 0])
        ox = int(ic[b, 0, 0, 1])
        np.testing.assert_array_equal(np.asarray(ic[b]),
                                      np.asarray(imgs[b, oy:oy+8, ox:ox+8]))
        np.testing.assert_array_equal(np.asarray(lc[b]),
                                      np.asarray(lbl[b, oy:oy+8, ox:ox+8]))
    ic2, _ = augment.random_crop(key, imgs, lbl, (8, 8), per_image=False)
    offs = {(int(ic2[b, 0, 0, 0]), int(ic2[b, 0, 0, 1])) for b in range(B)}
    assert len(offs) == 1  # reference tf.image.random_crop semantics


def test_train_step_crops_oversized_batch():
    """A (B, 2H, 2W) batch trains through the 192x256-analog step: the
    reference's 320x320-shards -> random-crop contract (calc2.py:256)."""
    model = train.create_model(CFG)
    tcfg = train.TrainConfig(batch_size=2, image_hw=HW)
    state = train.init_state(model, tcfg, jax.random.key(0))
    big_hw = (HW[0] * 2, HW[1] * 2)
    imgs, labels = synthetic_batch(jax.random.key(2), 2, big_hw)
    w = class_weights(labels)
    state, metrics = jax.jit(lambda s, r: train.train_step(
        model, tcfg, s, imgs, labels, w, r))(state, jax.random.key(3))
    assert np.isfinite(float(metrics["loss"]))


def test_hard_negative_excludes_self():
    d = jnp.eye(4)  # orthogonal descriptors
    dn = losses.hard_negative_mine(d)
    # Nearest non-self neighbor of e_i among {e_j} is some other e_j.
    assert not np.any(np.all(np.asarray(dn) == np.eye(4), axis=-1))


def test_infonce_gradient_in_compressed_regime():
    """In the aliasing regime (all cosines in [0.98, 1]) the margin-0.5
    hinge's gradient is the same whether the negative is 0.001 or 0.019
    away, while InfoNCE's is concentrated on the near-duplicates — and
    minimizing it separates positives from siblings."""
    key = jax.random.key(0)
    base = jax.random.normal(key, (6, 64))
    base = base / jnp.linalg.norm(base, axis=-1, keepdims=True)
    # Siblings: tiny perturbations of one anchor direction.
    d = base[0] + 0.08 * base  # rows all ~0.99 cosine to each other
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    dp = d + 0.02 * base[::-1]
    dp = dp / jnp.linalg.norm(dp, axis=-1, keepdims=True)
    assert float(jnp.min(d @ d.T)) > 0.98
    loss0 = losses.infonce_loss(d, dp, tau=0.01)
    assert bool(jnp.isfinite(loss0))
    # One gradient step on the descriptors must reduce the loss (the
    # pinned hinge, by contrast, has constant slope everywhere).
    g = jax.grad(lambda x: losses.infonce_loss(x, dp, 0.01))(d)
    assert float(jnp.linalg.norm(g)) > 0.0
    d1 = d - 0.05 * g
    d1 = d1 / jnp.linalg.norm(d1, axis=-1, keepdims=True)
    assert float(losses.infonce_loss(d1, dp, 0.01)) < float(loss0)


def test_total_loss_objectives_agree_on_shared_terms():
    """Both sim objectives are plumbed; seg/rec/kld terms identical."""
    key = jax.random.key(1)
    B, H, W = 2, 8, 8
    outs = {
        "descriptor": jax.random.normal(key, (B, 32)),
        "seg": jax.random.normal(jax.random.key(2), (B, H, W, 13)),
        "rec": jax.nn.sigmoid(jax.random.normal(jax.random.key(3),
                                                (B, H, W, 3))),
        "mu": jax.random.normal(jax.random.key(4), (B, 2, 2, 8)),
        "log_sig_sq": jax.random.normal(jax.random.key(5), (B, 2, 2, 8)),
    }
    outs["descriptor"] = outs["descriptor"] / jnp.linalg.norm(
        outs["descriptor"], axis=-1, keepdims=True)
    dp = jnp.roll(outs["descriptor"], 1, axis=0)
    imgs = jax.nn.sigmoid(jax.random.normal(jax.random.key(6), (B, H, W, 3)))
    lbl = jax.nn.one_hot(
        jax.random.randint(jax.random.key(7), (B, H, W), 0, 13), 13)
    w = jnp.ones(13)
    lt, mt = losses.total_loss(outs, dp, imgs, lbl, w)
    li, mi = losses.total_loss(outs, dp, imgs, lbl, w,
                               sim_objective="infonce", sim_tau=0.02)
    for k in ("segloss", "recloss", "kld", "sim_pos", "sim_neg"):
        np.testing.assert_allclose(float(mt[k]), float(mi[k]), rtol=1e-6)
    assert float(mt["simloss"]) != float(mi["simloss"])
    np.testing.assert_allclose(
        float(lt - mt["simloss"]), float(li - mi["simloss"]), rtol=1e-5)


def test_train_step_decreases_loss(model_and_state):
    model, tcfg, state = model_and_state
    imgs, labels = synthetic_batch(jax.random.key(2), 2, HW)
    w = class_weights(labels)

    step = jax.jit(lambda s, r: train.train_step(
        model, tcfg, s, imgs, labels, w, r))
    metrics0 = None
    for i in range(3):
        state, metrics = step(state, jax.random.key(10 + i))
        for k, v in metrics.items():
            assert bool(jnp.isfinite(v)), (k, v)
        if metrics0 is None:
            metrics0 = metrics
    assert float(metrics["loss"]) < float(metrics0["loss"])


def test_sharded_train_step_runs():
    """DP over an 8-device mesh (the MirroredStrategy equivalent)."""
    model = train.create_model(CFG)
    tcfg = train.TrainConfig(batch_size=8, image_hw=HW)
    state = train.init_state(model, tcfg, jax.random.key(0))
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    step = train.make_sharded_train_step(model, tcfg, mesh)
    imgs, labels = synthetic_batch(jax.random.key(3), 8, HW)
    w = class_weights(labels)
    state2, metrics = step(state, imgs, labels, w, jax.random.key(4))
    assert bool(jnp.isfinite(metrics["loss"]))
    assert int(state2.step) == 1


def test_fit_and_checkpoint_sweep(tmp_path):
    """Training-loop runner + checkpoint sweep (train_and_eval +
    find_best_checkpoint equivalents)."""
    from ekf_slam_tpu.utils import MetricsLogger

    model = train.create_model(CFG)
    tcfg = train.TrainConfig(batch_size=2, image_hw=HW, ckpt_every=2)
    imgs, labels = synthetic_batch(jax.random.key(5), 2, HW)
    batches = [(imgs, labels)]
    logger = MetricsLogger()
    state, metrics = train.fit(model, tcfg, batches, num_steps=4,
                               ckpt_dir=str(tmp_path), logger=logger)
    assert int(state.step) == 4
    assert len(logger.series("loss")) == 4
    # Two checkpoints written (steps 2 and 4); sweep picks the later one
    # under a score that favors high step counts.
    template = jax.tree.map(jnp.zeros_like, state)
    path, score = train.find_best_checkpoint(
        str(tmp_path), template, lambda s: float(s.step))
    assert path.endswith("0000004")
    assert score == 4.0


def test_decoder_group_isolation():
    """The grouped decoder routes DISJOINT latent slices: tower i's
    output depends only on z[..., 4i:4i+4]. This is the documented
    deviation from the reference's overlapping z[:,:,:,i:i+4] slicing
    (calc2.py:219 — towers share channels 0..16, channels 17..55 dead);
    see models/vss.py for the rationale."""
    from ekf_slam_tpu.models.vss import Decoder, VSSConfig

    cfg = VSSConfig(width=4)
    dec = Decoder(cfg)
    rng = jax.random.key(0)
    z = jax.random.normal(jax.random.key(1), (1, 4, 4, 4 * cfg.heads))
    variables = dec.init(rng, z, train=False)

    rec0, seg0 = dec.apply(variables, z, train=False)

    # Perturb ONLY group 3's latent slice (a seg tower): rec (group 0)
    # and every other seg channel must be bit-identical; seg channel 2
    # (tower 3 = seg index 2) must change.
    z2 = z.at[..., 12:16].add(1.0)
    rec1, seg1 = dec.apply(variables, z2, train=False)
    np.testing.assert_array_equal(np.asarray(rec0), np.asarray(rec1))
    assert not np.array_equal(np.asarray(seg0[..., 2]),
                              np.asarray(seg1[..., 2]))
    for ch in range(13):
        if ch == 2:
            continue
        np.testing.assert_array_equal(np.asarray(seg0[..., ch]),
                                      np.asarray(seg1[..., ch]))

    # Perturb group 0 (the reconstruction tower): seg untouched.
    z3 = z.at[..., 0:4].add(1.0)
    rec2, seg2 = dec.apply(variables, z3, train=False)
    np.testing.assert_array_equal(np.asarray(seg0), np.asarray(seg2))
    assert not np.array_equal(np.asarray(rec0), np.asarray(rec2))


def test_remat_bit_equivalent():
    """VSSConfig.remat=True (needed to fit the reference training shape
    in HBM, runs/r3g) is a lifted transform: identical parameter tree
    (checkpoint-compatible) and matching one-step training update."""

    hw = (32, 32)
    m0 = train.create_model(VSSConfig(width=8))
    m1 = train.create_model(VSSConfig(width=8, remat=True))
    tcfg = train.TrainConfig(batch_size=2, image_hw=hw)
    s0 = train.init_state(m0, tcfg, jax.random.key(0))
    s1 = train.init_state(m1, tcfg, jax.random.key(0))
    assert jax.tree.structure(s0.params) == jax.tree.structure(s1.params)
    for a, b in zip(jax.tree.leaves(s0.params), jax.tree.leaves(s1.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    imgs, labels = synthetic_batch(jax.random.key(1), 2, hw)
    w = class_weights(labels)
    s0b, me0 = jax.jit(lambda s, k: train.train_step(
        m0, tcfg, s, imgs, labels, w, k))(s0, jax.random.key(2))
    s1b, me1 = jax.jit(lambda s, k: train.train_step(
        m1, tcfg, s, imgs, labels, w, k))(s1, jax.random.key(2))
    np.testing.assert_allclose(float(me0["loss"]), float(me1["loss"]),
                               rtol=1e-6)
    for a, b in zip(jax.tree.leaves(s0b.params), jax.tree.leaves(s1b.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-6)


def test_d2s_convt_bit_equals_reshape(monkeypatch):
    """The one-hot conv_transpose depth-to-space (VSS_D2S=convt, the
    default — the reshape form's 7-D transpose materializes small-minor-
    dim temps at the reference training scale) is a bit-exact
    rearrangement."""
    from ekf_slam_tpu.models import vss as vss_mod

    for shape, heads in [((2, 3, 5, 14 * 16), 14), ((1, 4, 4, 14 * 4), 14),
                         ((2, 2, 2, 4), 1)]:
        x = jax.random.normal(jax.random.key(shape[1]), shape)
        monkeypatch.setattr(vss_mod, "_D2S", "reshape")
        a = vss_mod.grouped_depth_to_space(x, heads)
        monkeypatch.setattr(vss_mod, "_D2S", "convt")
        b = vss_mod.grouped_depth_to_space(x, heads)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_descr_variant_param_tree():
    """Descriptor variants (VSSConfig.descr_source / descr_intra_norm —
    aliasing-regime heads, docs/CALC2_RUN.md r3) are opt-in: the default
    config's parameter tree is byte-stable (checkpoint compatibility),
    d4 adds exactly the {mu_d4, offset_d4} head, and every variant
    returns a unit-norm descriptor of the documented dimension."""
    hw = (32, 32)
    tcfg = train.TrainConfig(batch_size=2, image_hw=hw)

    def init(cfg):
        m = train.create_model(cfg)
        s = train.init_state(m, tcfg, jax.random.key(0))
        return m, s

    m0, s0 = init(VSSConfig(width=8))
    m1, s1 = init(VSSConfig(width=8, descr_intra_norm=False))
    assert jax.tree.structure(s0.params) == jax.tree.structure(s1.params)

    m4, s4 = init(VSSConfig(width=8, descr_source="d4"))
    assert (set(s4.params) - set(s0.params)) == {"mu_d4", "offset_d4"}

    imgs = jax.random.uniform(jax.random.key(3), (2,) + hw + (3,))
    h, w = hw
    dim5 = (h // 16) * (w // 16) * 56
    dim4 = (h // 8) * (w // 8) * 56
    for cfg, dim in [(VSSConfig(width=8), dim5),
                     (VSSConfig(width=8, descr_intra_norm=False), dim5),
                     (VSSConfig(width=8, descr_source="d4"), dim4),
                     (VSSConfig(width=8, descr_source="multi"),
                      dim5 + dim4)]:
        m, s = init(cfg)
        outs = m.apply({"params": s.params, "batch_stats": s.batch_stats},
                       imgs, train=False, rngs={"reparam": jax.random.key(1)},
                       descriptor_only=True)
        d = np.asarray(outs["descriptor"])
        assert d.shape == (2, dim), (cfg.descr_source, d.shape)
        np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0,
                                   rtol=1e-5)
    # multi: cosine is the mean of the per-level cosines (equal-weight
    # concat of unit vectors).
    mm, sm = init(VSSConfig(width=8, descr_source="multi"))
    dm = np.asarray(mm.apply(
        {"params": sm.params, "batch_stats": sm.batch_stats}, imgs,
        train=False, rngs={"reparam": jax.random.key(1)},
        descriptor_only=True)["descriptor"])
    c_multi = float(dm[0] @ dm[1])
    c5 = float(np.dot(*(dm[:, :dim5] / np.linalg.norm(dm[:, :dim5], axis=-1,
                                                      keepdims=True))))
    c4 = float(np.dot(*(dm[:, dim5:] / np.linalg.norm(dm[:, dim5:], axis=-1,
                                                      keepdims=True))))
    np.testing.assert_allclose(c_multi, 0.5 * (c5 + c4), rtol=1e-5)


def test_train_severity_augmentation():
    """TrainConfig.aug_severity > 0 applies the seasonal_change
    appearance model to the positive view (docs/CALC2_RUN.md r3 severity
    sweep rationale): the step runs finite and produces a different
    update than the default, while aug_severity=0 keeps the original
    4-way RNG split (bit-reproducible default path)."""
    hw = (32, 32)
    m = train.create_model(VSSConfig(width=8))
    t0 = train.TrainConfig(batch_size=2, image_hw=hw)
    t1 = train.TrainConfig(batch_size=2, image_hw=hw, aug_severity=1.5)
    s = train.init_state(m, t0, jax.random.key(0))
    imgs, labels = synthetic_batch(jax.random.key(1), 2, hw)
    w = class_weights(labels)
    s0, me0 = jax.jit(lambda st, k: train.train_step(
        m, t0, st, imgs, labels, w, k))(s, jax.random.key(2))
    s1, me1 = jax.jit(lambda st, k: train.train_step(
        m, t1, st, imgs, labels, w, k))(s, jax.random.key(2))
    assert np.isfinite(float(me1["loss"]))
    # The augmented positive view must actually change the sim term.
    assert float(me0["simloss"]) != float(me1["simloss"])
