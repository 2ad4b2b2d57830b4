"""The plain reference against the program's CPU paths at small sizes, and
the pair generator."""
import numpy as np
import pytest
import torch

from portbench import generator
from portbench.reference import cascade as ref
from portbench.reference import loss as rloss
from portbench.reference import warp as rwarp
from torchregister_tpu_torch import losses
from torchregister_tpu_torch.engines.cascade import register_cascade
from torchregister_tpu_torch.ops.separable import _warp_affine_separable, warp_flow_separable
from torchregister_tpu_torch.ops.transforms import rigid_theta

S = (20, 24, 28)


@pytest.fixture(scope="module")
def pair():
    return generator.make_pair(np.random.default_rng(3), S, 4.0, "cpu")


def test_generator_repeats_per_seed():
    a = generator.make_pool(2**31 + 11, (16, 16, 16), 2, 1, (3.0, 7.0), "cpu")
    b = generator.make_pool(2**31 + 11, (16, 16, 16), 2, 1, (3.0, 7.0), "cpu")
    c = generator.make_pool(2**31 + 12, (16, 16, 16), 2, 1, (3.0, 7.0), "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x.moving, y.moving) and torch.equal(x.target, y.target)
        assert torch.equal(x.theta, y.theta) and x.max_disp == y.max_disp
    assert not torch.equal(a[0].moving, c[0].moving)
    # every seed holds the same displacements, in its own order
    assert sorted(p.max_disp for p in a) == sorted(p.max_disp for p in c) == [0.0, 3.0, 7.0]
    assert float(a[0].flow().abs().max()) == pytest.approx(a[0].max_disp)


def test_rigid_theta(pair):
    p = torch.tensor([0.05, -0.03, 0.04, 0.12, -0.1, 0.08])
    assert torch.equal(rwarp.rigid_theta(p), rigid_theta(p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_affine_warp(pair, dtype):
    theta = rwarp.rigid_theta(torch.tensor([0.05, -0.03, 0.04, 0.12, -0.1, 0.08]))
    got = rwarp.affine_warp(pair.moving, theta, 5, dtype)
    want = _warp_affine_separable(theta[None], pair.moving.to(dtype), max_shift=5)
    assert torch.equal(got.to(want.dtype), want)


def test_flow_warp_and_gradients(pair):
    flow = pair.flow().requires_grad_(True)
    got = rwarp.flow_warp(pair.moving, flow, 3)
    (g_ref,) = torch.autograd.grad(got.square().sum(), flow)
    flow2 = pair.flow().requires_grad_(True)
    want = warp_flow_separable(pair.moving, flow2, max_disp=3)
    (g_prog,) = torch.autograd.grad(want.square().sum(), flow2)
    assert torch.equal(got, want)
    assert torch.allclose(g_ref, g_prog, rtol=1e-5, atol=1e-6)


def test_criteria(pair):
    y, yp = pair.target, pair.moving
    assert torch.equal(rloss.mse(y, yp), losses.mse(y, yp))
    assert torch.equal(rloss.ncc(y, yp), losses.ncc(y, yp))


def test_adam_against_torch():
    p = torch.randn(50)
    q = p.clone().requires_grad_(True)
    mine, opt = rloss.Adam(p, 0.3), torch.optim.Adam([q], lr=0.3, foreach=False)
    for k in range(4):
        g = torch.randn(50, generator=torch.Generator().manual_seed(k))
        mine.step(g)
        q.grad = g.clone()
        opt.step()
    assert torch.allclose(p, q.detach(), rtol=1e-6, atol=1e-7)


def test_cascade_starts_and_final_warp():
    """The reference's checked stages against one RECIPE cascade at 64^3 on
    the CPU: the final warp and the rigid start to the bit, the flow start
    within f32 rounding; the affine stage's best loss within 1 % of the
    reference's at the answer (one resample where the program composed two),
    the last flow level's last loss within 20 % (a step before the answer's
    field; at 64^3 a step moves the loss by 1-10 %)."""
    from portbench.run import _keep, _recipe
    from portbench import check, registry

    recipe = _recipe(registry.cell("field240.pairs")["config_data"])
    p = generator.make_pair(np.random.default_rng(8), (64, 64, 64), 5.0, "cpu")
    res = register_cascade(p.moving, p.target, **recipe)
    assert torch.equal(ref.final_warp(p.moving, res.theta[0], res.flow, recipe), res.warped)
    assert torch.equal(ref.rigid_start(p.moving, p.target, recipe, 3), res.rigid_losses[:3])
    fl = ref.flow_start(p.moving, p.target, res.theta[0], recipe, 3)
    assert torch.allclose(fl, res.flow_losses[:3], rtol=1e-5, atol=0)
    gaps = check.gaps(p, _keep(res, 0, 1), recipe, ("affine_end_gap", "flow_end_gap"))
    assert gaps["affine_end_gap"][0] < 0.01 and gaps["flow_end_gap"][0] < 0.2, gaps


def test_level_budgets_split_the_records():
    """A stage's records are its levels' budgets one after the other, as
    the program splits its epochs."""
    assert ref.level_budgets(450, 3, 3.5) == [329, 94, 27]
    assert ref.level_budgets(200, 2, 3.5) == [156, 44]
