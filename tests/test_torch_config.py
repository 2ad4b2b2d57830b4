"""The port's config dataclasses: pinned to the port's engine signatures by
introspection (the drift pin of ``tests/test_config.py``) and to the JAX
package's dataclasses, field for field (the matrix engines' ``per`` too,
accepted and unused in both packages)."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import torchregister_tpu.config as jcfg
import torchregister_tpu_torch as tr
from torchregister_tpu_torch import config as tcfg
from torchregister_tpu_torch.engines.affine import affine_register
from torchregister_tpu_torch.engines.cascade import register_cascade
from torchregister_tpu_torch.engines.flow import flow_register
from torchregister_tpu_torch.engines.rigid import rigid_register
from torchregister_tpu_torch.synthetic import make_pair

PAIRS = [(tcfg.RigidConfig, rigid_register, jcfg.RigidConfig),
         (tcfg.AffineConfig, affine_register, jcfg.AffineConfig),
         (tcfg.FlowConfig, flow_register, jcfg.FlowConfig),
         (tcfg.CascadeConfig, register_cascade, jcfg.CascadeConfig)]
IDS = ["rigid", "affine", "flow", "cascade"]

# JAX engine arguments the port's engines do not take: none
NOT_PORTED = {
    "RigidConfig": set(),
    "AffineConfig": set(),
    "FlowConfig": set(),
    "CascadeConfig": set(),
}


def _sig_defaults(fn, skip=("moving", "target", "generator", "init_params", "init_theta")):
    return {name: p.default for name, p in inspect.signature(fn).parameters.items()
            if name not in skip and p.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("cfg_cls,engine,jax_cls", PAIRS, ids=IDS)
def test_torch_config_defaults_match_engine_signature(cfg_cls, engine, jax_cls):
    cfg = {f.name: f.default for f in dataclasses.fields(cfg_cls)}
    assert cfg == _sig_defaults(engine)


@pytest.mark.parametrize("cfg_cls,engine,jax_cls", PAIRS, ids=IDS)
def test_torch_config_matches_jax_config(cfg_cls, engine, jax_cls):
    ours = {f.name: f.default for f in dataclasses.fields(cfg_cls)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_cls)}
    assert set(theirs) - set(ours) == NOT_PORTED[cfg_cls.__name__]
    assert set(ours) <= set(theirs)
    for k, v in ours.items():
        assert theirs[k] == v, k


def test_torch_api_layer_grad_edges_override_pinned():
    assert tcfg.API_GRAD_EDGES is False
    assert tcfg.RigidConfig().grad_edges is True
    assert tcfg.AffineConfig().grad_edges is True
    grad_edges = inspect.signature(tr.Register.__init__).parameters["grad_edges"]
    assert grad_edges.default is tcfg.API_GRAD_EDGES


def test_torch_config_run_equals_direct_engine_call():
    m, t = make_pair((16, 16, 16), seed=1)
    cfg = tcfg.RigidConfig(lr=1e-3, epochs=5, criterions=("mse",), grad_edges=False,
                           optimizer="adam", init="identity")
    w1, r1 = cfg.run(m, t)
    w2, r2 = rigid_register(m, t, lr=1e-3, epochs=5, criterions=("mse",),
                            grad_edges=False, optimizer="adam", init="identity")
    torch.testing.assert_close(r1.best_theta, r2.best_theta, rtol=0, atol=0)
    torch.testing.assert_close(w1, w2, rtol=0, atol=0)
    _, r3 = cfg.run(m, t, epochs=3)  # overrides win over fields
    assert np.asarray(r3.losses).shape == (3,)
