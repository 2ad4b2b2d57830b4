"""The per-pair pieces of a cohort on the CPU: the criteria reduced per pair,
K1's plain affine passes with one row per pair, the optimizers and the
engine loop with a pair axis, each against the same call on each pair alone.

Each criterion runs on each pair's own slice (``losses.per_pair``), NMI
too (each pair's own range and density path), and K1's plain per-pair grid
takes each pair's single-pair ops, so their values and gradients are equal
to the bit.
"""
import importlib

import numpy as np
import pytest
import torch

from torchregister_tpu_torch.engines import common
from torchregister_tpu_torch.losses import (get_criterion, lncc, mse, ncc, pair_loss, per_pair,
                                            ssd)
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.separable import (_warp_affine_separable, affine_to_index_map,
                                                   factor_passes)
from torchregister_tpu_torch.ops.transforms import rigid_theta


def _pairs(B=3, spatial=(12, 13, 14), seed=0):
    """B image pairs ``[B, 1, *S]`` of different scales (pair 1 is 50x)."""
    rng = np.random.default_rng(seed)
    y = rng.random((B, 1) + spatial).astype(np.float32)
    yp = (0.7 * y + 0.3 * rng.random(y.shape)).astype(np.float32)
    y[1] *= 50.0
    yp[1] *= 50.0
    return torch.from_numpy(y), torch.from_numpy(yp)


def _value_and_grad(fn, y, yp):
    p = yp.clone().requires_grad_(True)
    v = fn(y, p)
    (g,) = torch.autograd.grad(v.sum(), p)
    return v.detach(), g


@pytest.mark.parametrize("name", ["mse", "ssd", "ncc", "lncc", "lncc_win5"])
def test_torch_pair_criteria_equal_each_pair_alone(name):
    crit = {"mse": mse, "ssd": ssd, "ncc": ncc, "lncc": lncc,
            "lncc_win5": get_criterion("lncc", win=5)}[name]
    y, yp = _pairs()
    v, g = _value_and_grad(per_pair(crit, 3), y, yp)
    assert v.shape == (3,)
    for b in range(3):
        vb, gb = _value_and_grad(crit, y[b:b + 1], yp[b:b + 1])
        assert torch.equal(v[b], vb) and torch.equal(g[b:b + 1], gb), b


def test_torch_pair_nmi_on_both_branches():
    """NMI per pair with the pairs on different density paths: at bandwidth
    0.02 the unit-range pairs' fine grid is resolved (the binned KDE) and
    the 50x pair's is not (the exact KDE)."""
    nmi_mod = importlib.import_module("torchregister_tpu_torch.losses.nmi")
    crit = get_criterion("nmi", bandwidth=0.02, patch_size=8)
    y, yp = _pairs()
    before = dict(nmi_mod.branch_calls)
    v, g = _value_and_grad(per_pair(crit, 3), y, yp)
    took = {k: nmi_mod.branch_calls[k] - before[k] for k in before}
    assert took == {"binned": 2, "exact": 1}
    for b in range(3):
        vb, gb = _value_and_grad(crit, y[b:b + 1], yp[b:b + 1])
        assert torch.equal(v[b], vb) and torch.equal(g[b:b + 1], gb), b


def test_torch_pair_loss_weights_and_a_batch_of_one():
    """The weighted sum per pair; one pair is the whole tensor reduced,
    shaped ``[1]`` (two items as one pair: the single-pair loss of both);
    any callable runs on each pair's slice."""
    y, yp = _pairs()
    crits, w = (mse, ncc), (0.3, 0.7)
    got = pair_loss(crits, w, 3)(y, yp)
    want = torch.stack([0.3 * mse(y[b:b + 1], yp[b:b + 1]) + 0.7 * ncc(y[b:b + 1], yp[b:b + 1])
                        for b in range(3)])
    assert torch.equal(got, want)
    one = pair_loss(crits, w, 1)(y[:1], yp[:1])
    assert one.shape == (1,) and torch.equal(one[0], want[0])
    both = pair_loss(crits, w, 1)(y[:2], yp[:2])
    assert torch.equal(both[0], 0.3 * mse(y[:2], yp[:2]) + 0.7 * ncc(y[:2], yp[:2]))

    def custom(a, b):
        return torch.mean(torch.abs(a - b))

    got = pair_loss((custom,), (1.0,), 3)(y, yp)
    assert torch.equal(got, torch.stack([custom(y[b:b + 1], yp[b:b + 1]) for b in range(3)]))


def _pair_passes(B, spatial, seed):
    gen = torch.Generator().manual_seed(seed)
    d = len(spatial)
    params = 0.3 * (2.0 * torch.rand((B, 6 if d == 3 else 3), generator=gen) - 1.0)
    return factor_passes(*affine_to_index_map(rigid_theta(params), spatial))


@pytest.mark.parametrize("spatial", [(9, 10, 11), (13, 12)], ids=["3d", "2d"])
def test_torch_sweep_affine_plain_rows_per_pair(spatial):
    """K1's plain affine pass with one row per pair equals the single-row
    pass on each pair, values and the rows' gradients to the bit; so does
    the whole separable warp with one theta per pair."""
    B, K = 3, 4
    src = torch.from_numpy(np.random.default_rng(1).random((B, 1) + spatial).astype(np.float32))
    passes = _pair_passes(B, spatial, 2)
    for axis, (coef, offset) in passes:
        c, o = coef.clone().requires_grad_(True), offset.clone().requires_grad_(True)
        out = k1.sweep_affine_plain(src, c, o, axis, K)
        gc, go = torch.autograd.grad(out.sum(), (c, o))
        for b in range(B):
            cb, ob = coef[b].clone().requires_grad_(True), offset[b].clone().requires_grad_(True)
            ref = k1.sweep_affine_plain(src[b:b + 1], cb, ob, axis, K)
            rc, ro = torch.autograd.grad(ref.sum(), (cb, ob))
            assert torch.equal(out[b:b + 1], ref)
            assert torch.equal(gc[b], rc) and torch.equal(go[b], ro)
    gen = torch.Generator().manual_seed(3)
    d = len(spatial)
    theta = rigid_theta(0.2 * torch.rand((B, 6 if d == 3 else 3), generator=gen))
    out = _warp_affine_separable(theta, src, max_shift=K)
    for b in range(B):
        assert torch.equal(out[b:b + 1], _warp_affine_separable(theta[b:b + 1], src[b:b + 1],
                                                                max_shift=K))
    with pytest.raises(ValueError, match="one theta or one per item"):
        _warp_affine_separable(theta[:2], src, max_shift=K)


def test_torch_sweep_affine_table_per_item_validates_first(monkeypatch):
    """A table per item must have the batch's length; checked before any
    build (the wrapper on the CPU raises for the device after it)."""
    def fail():
        raise AssertionError("the library was built before the inputs were checked")

    monkeypatch.setattr(k1.LIB, "build", fail)
    monkeypatch.setattr(k1.LIB, "_fns", None)
    src = torch.zeros((2, 1, 5, 6, 7))
    with pytest.raises(ValueError, match=r"table \[3, 4\] or \[2, 3, 4\]"):
        k1._SeparableAffine.apply(src, torch.zeros((3, 3, 4)), (2, 1, 0), (2, 2, 2))
    with pytest.raises(ValueError, match="CUDA device"):
        k1._SeparableAffine.apply(src, torch.zeros((2, 3, 4)), (2, 1, 0), (2, 2, 2))


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_torch_optimizers_per_pair(name):
    """``active [B]``: each pair's update equals its single-pair update to the
    bit, and a masked pair's parameters and state stay as they were."""
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn((3, 5), generator=gen)
    grads = [torch.randn((3, 5), generator=gen) for _ in range(4)]
    masks = [[True, True, True], [True, False, True], [True, False, False], [True, True, False]]
    batch = p0.clone()
    opt = common.make_optimizer(name, batch, 0.01, 10, pairs=3)
    singles = [p0[b].clone() for b in range(3)]
    opts = [common.make_optimizer(name, s, 0.01, 10) for s in singles]
    for g, m in zip(grads, masks):
        opt.step(g, torch.tensor(m))
        for b in range(3):
            opts[b].step(g[b], torch.tensor(m[b]))
    for b in range(3):
        assert torch.equal(batch[b], singles[b])
        for k in ("m", "v"):
            if k in opt.state:
                assert torch.equal(opt.state[k][b], opts[b].state[k])
        if "t" in opt.state:
            assert torch.equal(opt.state["t"][b:b + 1], opts[b].state["t"])
    if name == "adam":
        assert opt.state["t"].tolist() == [4, 2, 2]


def test_torch_optimize_scan_pairs_stop_on_their_own():
    """Three pairs of one quadratic-plus-ripple loss with different
    optima: each stops at its own plateau step, equal to its single run's,
    with the same losses, history, best pick and final parameters; the host
    reads only where the first running pair's stop could fire."""
    C = torch.tensor([[0.3, -0.2, 0.5, 0.1], [0.0, 0.0, 0.0, 0.0], [2.0, -1.5, 0.7, 0.9]])

    def loss_of(c):
        return lambda p: (torch.sum((p - c) ** 2, dim=-1)
                          + 0.05 * torch.sum(torch.sin(20.0 * p), dim=-1) + 1.0)

    kw = dict(optimizer="adam", lr=0.05, epochs=200, stop_rel=1e-3, patience=8)
    common.reset_counts()
    final, best, best_loss, losses, hist, steps = common.optimize_scan(
        loss_of(C), torch.zeros((3, 4)), label="pairs", **kw)
    assert len(set(steps)) == 3, steps
    assert common.host_reads["pairs"] < max(steps) // 2
    for b in range(3):
        f1, b1, bl1, l1, h1, s1 = common.optimize_scan(loss_of(C[b]), torch.zeros(4), **kw)
        assert steps[b] == s1
        for got, want in ((final[b], f1), (best[b], b1), (best_loss[b], bl1)):
            assert torch.equal(got, want)
        assert torch.equal(losses[b].nan_to_num(-1.0), l1.nan_to_num(-1.0))
        assert torch.equal(hist[b].nan_to_num(-1.0), h1.nan_to_num(-1.0))
