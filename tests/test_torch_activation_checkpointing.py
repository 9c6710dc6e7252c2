"""The port's ``runtime/activation_checkpointing`` in the scenarios of
``tests/unit/test_activation_checkpointing.py``, held against JAX's
gradients: a checkpointed call gives bitwise the plain call's gradients
in the port and JAX's within fp32 summation order (1e-4 relative and
1e-5 absolute: the gradients reach 3 in magnitude), under every policy
name and alias, with CPU checkpointing, through the decorator, and with
the CPU RNG restored for the recompute; the RNG tracker forks
deterministically on explicit ``torch.Generator``s."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

POLICIES = ["nothing_saveable", "everything_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "full", "none", "dots",
            "dots_no_batch"]


@pytest.fixture(autouse=True)
def _reset():
    checkpointing.reset()
    yield
    checkpointing.reset()


def _mlp(w1, w2, x):
    return (torch.tanh(x @ w1) @ w2).sum()


def _jmlp(p, x):
    return jnp.sum(jnp.tanh(x @ p["w1"]) @ p["w2"])


def _params():
    rng = np.random.default_rng(0)
    return {"w1": rng.normal(size=(16, 32)).astype(np.float32),
            "w2": rng.normal(size=(32, 8)).astype(np.float32)}


def _x(shape=(4, 16)):
    return np.random.default_rng(1).normal(size=shape).astype(np.float32)


def _port_grads(call, params, x):
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    call(w["w1"], w["w2"], torch.from_numpy(x)).backward()
    return {k: t.grad for k, t in w.items()}


def _check(got, want_port, want_jax):
    for k in want_jax:
        assert torch.equal(got[k], want_port[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_jax[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_configure_and_is_configured():
    assert not checkpointing.is_configured()
    checkpointing.configure(None, deepspeed_config={
        "activation_checkpointing": {"partition_activations": False,
                                     "cpu_checkpointing": True,
                                     "policy": "dots"}})
    assert checkpointing.is_configured()
    cfg = checkpointing.get_config()
    assert cfg["cpu_checkpointing"] and cfg["policy"] == "dots"
    assert deepspeed_tpu_torch.checkpointing is checkpointing
    # partitioned activations shard over tp ranks: the port has no tp yet,
    # and a refused configure leaves the configuration as it was
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        checkpointing.configure(None, deepspeed_config={
            "activation_checkpointing": {"partition_activations": True}})
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        checkpointing.configure(None, partition_activations=True)
    assert checkpointing.get_config() == cfg
    checkpointing.configure(None, contiguous_checkpointing=True)
    assert checkpointing.get_config()["contiguous_memory_optimization"]


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpoint_matches_plain_grads(policy):
    checkpointing.configure(None, policy=policy)
    params, x = _params(), _x()
    want_jax = jax.grad(lambda p: _jmlp(p, x))(params)
    want = _port_grads(_mlp, params, x)
    got = _port_grads(lambda *a: checkpointing.checkpoint(_mlp, *a),
                      params, x)
    _check(got, want, want_jax)


def test_unknown_policy_warns_and_recomputes_everything(monkeypatch):
    said = []
    monkeypatch.setattr(checkpointing.logger, "warning", said.append)
    checkpointing.configure(None, policy="no_such_policy")
    params, x = _params(), _x()
    got = _port_grads(lambda *a: checkpointing.checkpoint(_mlp, *a),
                      params, x)
    assert said and "no_such_policy" in said[0]
    _check(got, _port_grads(_mlp, params, x),
           jax.grad(lambda p: _jmlp(p, x))(params))


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpoint_of_closed_over_parameters(policy):
    """A region whose only argument is data (no gradient) still
    differentiates the parameters it closes over, as ``jax.checkpoint``
    does: bitwise the plain call's gradients, JAX's within tolerance."""
    checkpointing.configure(None, policy=policy)
    params, x = _params(), _x()

    def closed(w1, w2, x):
        return checkpointing.checkpoint(lambda d: _mlp(w1, w2, d), x)

    got = _port_grads(closed, params, x)
    _check(got, _port_grads(_mlp, params, x),
           jax.grad(lambda p: _jmlp(p, x))(params))


def test_region_that_reaches_no_gradient_needs_none():
    """A region over data and constants alone gives an output that needs
    no gradient, as the plain call's does."""
    checkpointing.configure(None)
    params, x = _params(), _x()
    w = [torch.from_numpy(params[k]) for k in ("w1", "w2")]
    got = checkpointing.checkpoint(_mlp, *w, torch.from_numpy(x))
    assert not got.requires_grad
    assert torch.equal(got, _mlp(*w, torch.from_numpy(x)))


def test_checkpoint_without_grad_runs_plainly():
    """Under ``torch.no_grad()`` (JAX: outside a transform) the call is
    the plain function's; keyword arguments pass through."""
    checkpointing.configure(None)
    params, x = _params(), _x((2, 16))
    w = [torch.from_numpy(params[k]) for k in ("w1", "w2")]
    with torch.no_grad():
        got = checkpointing.checkpoint(_mlp, *w, x=torch.from_numpy(x))
    assert torch.equal(got, _mlp(*w, torch.from_numpy(x)))


def test_cpu_checkpointing_policy_still_correct():
    checkpointing.configure(None, checkpoint_in_cpu=True, policy="dots")
    params, x = _params(), _x((2, 16))
    got = _port_grads(lambda *a: checkpointing.checkpoint(_mlp, *a),
                      params, x)
    _check(got, _port_grads(_mlp, params, x),
           jax.grad(lambda p: _jmlp(p, x))(params))


def test_checkpoint_wrapper():
    checkpointing.configure(None)
    fn = checkpointing.checkpoint_wrapper(_mlp)
    assert fn.__name__ == "_mlp"
    params, x = _params(), _x((2, 16))
    got = _port_grads(fn, params, x)
    assert all(np.isfinite(g.numpy()).all() for g in got.values())
    _check(got, _port_grads(_mlp, params, x),
           jax.grad(lambda p: _jmlp(p, x))(params))


def test_recompute_replays_the_forward_rng():
    """A region that draws random numbers (dropout) recomputes with the
    forward's draws: gradients bitwise the plain call's from the same
    seed; closed-over parameters get their gradients too."""
    lin = torch.nn.Linear(16, 8)

    def fn(x):
        return torch.nn.functional.dropout(lin(x), 0.5).square().sum()

    x = torch.from_numpy(_x()).requires_grad_()
    torch.manual_seed(3)
    fn(x).backward()
    want = (x.grad.clone(), lin.weight.grad.clone())
    x.grad, lin.weight.grad = None, None
    checkpointing.configure(None)
    torch.manual_seed(3)
    checkpointing.checkpoint(fn, x).backward()
    assert torch.equal(x.grad, want[0])
    assert torch.equal(lin.weight.grad, want[1])


def test_rng_tracker_fork_deterministic():
    t1 = checkpointing.model_parallel_cuda_manual_seed(1234, device="cpu")
    with t1.fork() as g1:
        a = torch.randn(4, generator=g1)
    t2 = checkpointing.model_parallel_cuda_manual_seed(1234, device="cpu")
    with t2.fork() as g2:
        b = torch.randn(4, generator=g2)
    assert torch.equal(a, b)
    # a second fork continues the stream: different numbers
    with t2.fork() as g3:
        c = torch.randn(4, generator=g3)
    assert not torch.allclose(b, c)
    # the data-parallel state is its own stream; states save and restore
    states = t2.get_states()
    with t2.fork("data-parallel-rng") as g:
        d = torch.randn(4, generator=g)
    t2.set_states(states)
    with t2.fork("data-parallel-rng") as g:
        assert torch.equal(torch.randn(4, generator=g), d)
    with pytest.raises(Exception, match="already exists"):
        t2.add("data-parallel-rng", 1, device="cpu")
    with pytest.raises(Exception, match="not added"):
        with t2.fork("nope"):
            pass
