"""``correct`` comes out true for a sound run and false for its control and
for each fault a cell can have, driven through the rest of a run on the CPU
at 32^3 (the timed path broken underneath; the look for a card skipped)."""
import contextlib

import pytest
import torch

from portbench import check, registry, run
from torchregister_tpu_torch.engines import cascade, common, flow

SMALL = (32, 32, 32)
SEED = 2**31 + 77


# At 32^3 and 48^3 on the CPU one step of the last flow level moves its loss
# by 0.3-9 % (10 pairs), where at 240^3 on the card the median pair moves it
# by 0.04-1.3 %: this size holds that number at 0.2, every other at the
# configuration's limit. The last level's diffusion term left out reads ~1.
SMALL_FINE_LIMIT = 0.2


def _run(workload, traffic=None, recipe=None):
    cell = registry.cell(workload)
    cell["config_data"]["checks"]["flow_end_gap_median"]["limit"] = SMALL_FINE_LIMIT
    if traffic:
        cell["traffic_data"] = {**cell["traffic_data"], **traffic}
    return run.run_cell(cell, SEED, 0.0, False, device="cpu", shape=SMALL, recipe=recipe)


# a batch of 2 stands in for the cohort's 8 at this size
COHORT = {"deformable": 2, "rigid": 0, "batch": 2}



# two pairs of the mix stand in for its sixteen at this size
PAIRS = {"deformable": 2, "rigid": 0}


@pytest.mark.parametrize("workload", ["field240.pairs"])
def test_sound_run_is_correct(workload):
    rec = _run(workload, PAIRS)
    assert rec["correct"], rec["checks"]


@pytest.mark.parametrize("workload", ["field240.pairs"])
def test_control_is_not_correct(workload):
    """The program's own bfloat16 flow path fails the flow start; the
    reference a precision low in the program's place fails the final warp
    (bfloat16 images), the rigid start and the affine stage's end (float8
    images)."""
    cell = registry.cell(workload)
    recipe = {**run._recipe(cell["config_data"]), **cell["config_data"]["control"]}
    rec = _run(workload, PAIRS, recipe=recipe)
    assert rec["checks"]["flow_loss_gap"]["value"] > rec["checks"]["flow_loss_gap"]["limit"]
    assert not rec["correct"]
    checks = cell["config_data"]["checks"]
    pool = run.make_pool(SEED, SMALL, 1, 0, (3.0, 7.0), "cpu")
    res = cascade.register_cascade(pool[0].moving, pool[0].target,
                                   **run._recipe(cell["config_data"]))
    low = check.control_readings(pool[0], run._keep(res, 0, 1),
                                 run._recipe(cell["config_data"]), checks)
    for name in ("warp_gap", "rigid_loss_gap", "affine_end_gap"):
        assert low[name] > checks[name]["limit"], name


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged_step(self, grad, active):
    """A step that returns its state unchanged."""


def _altered_warp(src, f, max_disp=8):
    """The registered image altered where it is produced."""
    out = _ORIGINAL_WARP(src, f, max_disp=max_disp).clone()
    out[..., 16, 16, 16] += 0.01
    return out


_ORIGINAL_WARP = cascade.warp_flow_separable


def _half_batch_loss(criteria, weights, pairs):
    """The batch's second half left out: its pairs take the mean of the
    first half's losses, with no gradient."""
    full = _ORIGINAL_PAIR_LOSS(criteria, weights, pairs)

    def loss(y, yp):
        val = full(y, yp)
        h = pairs // 2
        return torch.cat([val[:h], val[:h].mean().detach().expand(pairs - h)])

    return loss


_ORIGINAL_PAIR_LOSS = flow.pair_loss


class _Doubled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


def _doubled_backward(criteria, weights, pairs):
    """The flow stage's warped image's gradient doubled (K1's backward
    mis-scaled), the diffusion term's left as it is."""
    full = _ORIGINAL_PAIR_LOSS(criteria, weights, pairs)
    return lambda y, yp: full(y, _Doubled.apply(yp))


_ORIGINAL_DIFFUSION = flow._diffusion_energy


def _fine_diffusion_dropped(f, pairs=1):
    """The last flow level's diffusion term left out (full resolution)."""
    val = _ORIGINAL_DIFFUSION(f, pairs)
    return val * 0 if tuple(f.shape[2:]) == SMALL else val


_FAULTS = {
    "step-unchanged": (common.Adam, "step", _unchanged_step),
    "answer-altered": (cascade, "warp_flow_separable", _altered_warp),
    "backward-doubled": (flow, "pair_loss", _doubled_backward),
    "fine-diffusion-dropped": (flow, "_diffusion_energy", _fine_diffusion_dropped),
    "half-batch": (flow, "pair_loss", _half_batch_loss),
}


@pytest.mark.parametrize("fault,workload,traffic", [
    ("step-unchanged", "field240.pairs", PAIRS),
    ("answer-altered", "field240.pairs", PAIRS),
    ("backward-doubled", "field240.pairs", PAIRS),
    ("fine-diffusion-dropped", "field240.pairs", PAIRS),
    ("step-unchanged", "field240.cohort8", COHORT),
    ("half-batch", "field240.cohort8", COHORT),
    ("answer-altered", "field240.cohort8", COHORT),
], ids=["pairs-step-unchanged", "pairs-answer-altered", "pairs-backward-doubled",
        "pairs-fine-diffusion-dropped", "cohort-step-unchanged", "cohort-half-batch",
        "cohort-answer-altered"])
def test_fault_is_not_correct(fault, workload, traffic):
    with _patched(*_FAULTS[fault]):
        rec = _run(workload, traffic)
    assert not rec["correct"], rec["checks"]


def test_sound_cohort_is_correct():
    rec = _run("field240.cohort8", COHORT)
    assert rec["correct"], rec["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in registry.benchmark()["workloads"]])
def test_cell_on_the_card(workload):
    """Each cell at its own size on the card, a short window: correct."""
    cell = registry.cell(workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        pytest.skip(f"needs {cell['chips']} CUDA device(s)")
    rec = run.run_cell(cell, SEED, 5.0, False)
    assert rec["correct"], rec["checks"]
