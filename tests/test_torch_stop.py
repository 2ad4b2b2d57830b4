"""The engines' loops with their stop state on the device, on the CPU.

``optimize_scan`` and ``flow_register`` (field mode, and the U-Net at depth
1) read the host only where a stop could fire (``common._next_read``), at
most ``common.READ_EVERY`` steps apart, and mask the steps after a stop.
Their results must equal, to the bit, those of the same loop reading after
every step (``READ_EVERY = 1``): the records, the best and final
parameters, the steps and ``converged``; ``optimize_scan`` also equals a
host loop with ``torch.optim`` and a ``.item()`` a step, the loop it
replaces. The hand-written ``SGD`` and ``Adam`` equal ``torch.optim``'s
single-tensor forms (``foreach=False``) to the bit over 100 steps, and a
masked step changes nothing.
"""
import numpy as np
import pytest
import torch

from torchregister_tpu_torch.engines import common
from torchregister_tpu_torch.engines.flow import flow_register
from torchregister_tpu_torch.synthetic import make_pair

C = np.array([0.3, -0.2, 0.5, 0.1], np.float32)
EPOCHS = 80
PATIENCE = 5
EVERY = common.READ_EVERY  # the loops' default cap, before a test patches it


def _loss(p):
    c = torch.from_numpy(C)
    return torch.sum((p - c) ** 2) + 0.05 * torch.sum(torch.sin(20.0 * p)) + 1.0


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def _same(a, b) -> bool:
    """Equal to the bit (NaN padding included)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _host_loop(optimizer, lr, epochs, stop_rel, patience):
    """The loop ``optimize_scan`` replaces: ``torch.optim`` and one
    ``.item()`` a step, the stop state on the host in f32."""
    params = torch.zeros(4, requires_grad=True)
    opt = (torch.optim.SGD([params], lr=lr) if optimizer == "sgd"
           else torch.optim.Adam([params], lr=lr, foreach=False))
    losses = np.full((epochs,), np.nan, np.float32)
    hist = np.full((epochs, 4), np.nan, np.float32)
    best, best_p, ref = np.float32(np.inf), params.detach().clone(), np.float32(np.inf)
    factor = None if stop_rel is None else np.float32(1.0 - stop_rel)
    since = i = 0
    while i < epochs:
        if factor is not None and since >= patience and best > ref * factor:
            break
        opt.zero_grad(set_to_none=True)
        loss = _loss(params)
        loss.backward()
        pre = params.detach().clone()
        val = np.float32(loss.item())
        opt.step()
        if val < best:
            best, best_p = val, pre
        losses[i], hist[i] = val, pre.numpy()
        if factor is not None:
            if best < ref * factor:
                ref, since = best, 0
            else:
                since += 1
        i += 1
    return (params.detach(), best_p, torch.tensor(best), torch.from_numpy(losses),
            torch.from_numpy(hist), i)


def _scan(monkeypatch, every, **kw):
    monkeypatch.setattr(common, "READ_EVERY", every)
    common.reset_counts()
    out = common.optimize_scan(_loss, torch.zeros(4), kw.pop("optimizer", "adam"),
                               kw.pop("lr", 0.05), EPOCHS, patience=PATIENCE, **kw)
    return out, common.host_reads.get("optimize_scan", 0)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("stop_rel", [None, 1e-3], ids=["scan", "plateau"])
def test_torch_stop_optimize_scan_scheduled_equals_every_step(monkeypatch, optimizer,
                                                              stop_rel):
    sched, _ = _scan(monkeypatch, EVERY, optimizer=optimizer, stop_rel=stop_rel)
    every, reads_every = _scan(monkeypatch, 1, optimizer=optimizer, stop_rel=stop_rel)
    host = _host_loop(optimizer, 0.05, EPOCHS, stop_rel, PATIENCE)
    for a, b, c in zip(sched, every, host):
        assert _same(a, b)
        assert _same(a, c)
    if stop_rel is not None:
        assert sched[-1] < EPOCHS  # the plateau stop fired
        assert reads_every == sched[-1]


def _plateau_reads(losses: np.ndarray, steps: int, every: int) -> int:
    """The reads ``_next_read`` schedules on this trajectory: the plateau
    counter after each step, from the recorded losses in f32."""
    factor = np.float32(1.0 - 1e-3)
    best = ref = np.float32(np.inf)
    since_after = [0]
    since = 0
    for v in losses[:steps]:
        best = min(best, v)
        if best < ref * factor:
            ref, since = best, 0
        else:
            since += 1
        since_after.append(since)
    reads = i = 0
    while True:
        i = min(EPOCHS, i + max(1, PATIENCE - since_after[i]), i + every)
        reads += 1
        if i >= steps:
            return reads


def test_torch_stop_optimize_scan_host_reads(monkeypatch):
    """One read without ``stop_rel``; on a plateau run fewer reads than
    steps, as many as the schedule predicts, with or without the cap."""
    (*_, steps), reads = _scan(monkeypatch, EVERY)
    assert steps == EPOCHS and reads == 1
    for every in (EVERY, 3):
        out, reads = _scan(monkeypatch, every, stop_rel=1e-3)
        steps = out[-1]
        assert reads < steps < EPOCHS
        assert reads == _plateau_reads(out[3].numpy(), steps, every)


def test_torch_stop_optimize_scan_progress_lines(monkeypatch, capsys):
    """``progress_every`` prints the per-step loop's lines: every N steps,
    and the plateau stop with the step it fired at."""
    (*_, steps), _ = _scan(monkeypatch, EVERY, stop_rel=1e-3, progress_every=4,
                           label="scan")
    lines = capsys.readouterr().out.splitlines()
    epochs = [int(ln.split("epoch ")[1].split("/")[0]) for ln in lines if "best_loss" in ln]
    assert epochs == list(range(4, steps, 4)) + [steps]
    assert lines[-1] == f"[scan] plateau early-stop at epoch {steps}"


# --------------------------------------------------------------- the flow loop

SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def pair():
    return make_pair(SHAPE, seed=2)


def _flow(monkeypatch, pair, every, **kw):
    monkeypatch.setattr(common, "READ_EVERY", every)
    common.reset_counts()
    model = kw.pop("flow_model", "field")
    base = (dict(lr=0.3, optimizer="adam", smooth=0.25) if model == "field"
            else dict(lr=1e-2, optimizer="adam", depth=1, n=16, zero_head=True,
                      generator=torch.Generator().manual_seed(0)))
    warped, res = flow_register(*pair, criterions=["mse", "ncc"], flow_model=model,
                                max_disp=4, check_disp=False, **{**base, **kw})
    return warped, res, common.host_reads.get("flow_register", 0)


def _flow_reads(losses: np.ndarray, steps: int, max_epochs: int, stop_rel, patience) -> int:
    """The reads the flow loop schedules on this trajectory: the plateau
    counter after each step (the step's loss against the reference, in f32),
    reads after steps 1, 2, 4, ... at most ``EVERY`` apart."""
    since_after, since, ref = [0], 0, np.float32(np.inf)
    for v in losses[:steps]:
        if stop_rel is not None and v < ref * np.float32(1.0 - stop_rel):
            ref, since = v, 0
        else:
            since += 1
        since_after.append(since)
    reads = i = 0
    while True:
        nxt = min(max_epochs, i + min(EVERY, max(1, i)))
        if stop_rel is not None:
            nxt = min(nxt, i + max(1, patience - since_after[i]))
        i, reads = nxt, reads + 1
        if i >= steps:
            return reads


CASES = {"no_stop_rel": dict(max_epochs=40, stop_crit=float("-inf")),
         "plateau": dict(max_epochs=80, stop_crit=float("-inf"), stop_rel=0.1, patience=2)}


@pytest.mark.parametrize("model", ["field", "unet"])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_stop_flow_scheduled_equals_every_step(monkeypatch, pair, model, case):
    kw = dict(CASES[case], flow_model=model)
    w1, r1, reads = _flow(monkeypatch, pair, EVERY, **kw)
    w2, r2, reads_every = _flow(monkeypatch, pair, 1, **kw)
    assert _same(w1, w2)
    for name in ("flow", "losses", "steps", "converged", "params", "max_disp"):
        assert _same(getattr(r1, name), getattr(r2, name)), name
    assert reads_every == r1.steps and reads < r1.steps
    assert reads == _flow_reads(r1.losses.numpy(), r1.steps, kw["max_epochs"],
                                kw.get("stop_rel"), kw.get("patience"))
    if case == "plateau":
        assert r1.steps < kw["max_epochs"]


@pytest.mark.parametrize("model", ["field", "unet"])
def test_torch_stop_flow_stop_crit_between_reads(monkeypatch, pair, model):
    """A ``stop_crit`` that fires at step 7: the scheduled loop reads after
    steps 1, 2, 4 and 8, masks the step after the stop, and equals the loop
    that reads every step."""
    _, free, _ = _flow(monkeypatch, pair, 1, flow_model=model, max_epochs=30,
                       stop_crit=float("-inf"))
    crit = float(free.losses[6])  # the loss of step 7
    assert np.all(free.losses.numpy()[:6] > crit)
    kw = dict(flow_model=model, max_epochs=30, stop_crit=crit)
    w1, r1, reads = _flow(monkeypatch, pair, EVERY, **kw)
    w2, r2, _ = _flow(monkeypatch, pair, 1, **kw)
    assert r1.steps == 7 and r1.converged and reads == 4
    assert _same(w1, w2)
    for name in ("flow", "losses", "steps", "converged", "params"):
        assert _same(getattr(r1, name), getattr(r2, name)), name
    assert np.isnan(r1.losses.numpy()[7:]).all()


# ----------------------------------------------------------------- optimizers


def _grads(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("shape", [(37,), (3, 5, 7)])
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_torch_stop_optimizers_equal_torch_optim(name, shape):
    """100 steps on the same gradients (and on gradients that grow with the
    parameters) against ``torch.optim``'s single-tensor form, to the bit."""
    rng = np.random.default_rng(1)
    p0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ref = p0.clone().requires_grad_(True)
    opt_ref = (torch.optim.SGD([ref], lr=0.05, foreach=False) if name == "sgd"
               else torch.optim.Adam([ref], lr=0.05, foreach=False))
    ours = p0.clone()
    opt = common.make_optimizer(name, ours, 0.05, 100)
    on = torch.tensor(True)
    for k, g in enumerate(_grads(shape, 100, 2)):
        g = g + 0.5 * ours if k % 2 else g
        ref.grad = g.clone()
        opt_ref.step()
        opt.step(g, on)
        assert torch.equal(_bits(ours), _bits(ref)), k
    if name == "adam":
        st = opt_ref.state[ref]
        assert torch.equal(_bits(opt.state["m"]), _bits(st["exp_avg"]))
        assert torch.equal(_bits(opt.state["v"]), _bits(st["exp_avg_sq"]))
        assert int(opt.state["t"]) == int(st["step"]) == 100


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_torch_stop_masked_step_changes_nothing(name):
    """A step with ``active`` False, even on a non-finite gradient, leaves
    the parameter and the optimizer's state as they were."""
    p = torch.linspace(-1, 1, 11)
    opt = common.make_optimizer(name, p, 0.1, 10)
    for g in _grads((11,), 3, 3):
        opt.step(g, torch.tensor(True))
    before = [p.clone()] + [v.clone() for v in opt.state.values()]
    bad = torch.full((11,), float("nan"))
    opt.step(bad, torch.tensor(False))
    after = [p] + list(opt.state.values())
    assert all(torch.equal(a, b) for a, b in zip(before, after))
